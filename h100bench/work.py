"""The work a unit of a cell needs, counted by the benchmark.

- `flops`: the model FLOPs of one train step or one served batch at the
  cell's shapes, counted by `torch.utils.flop_counter.FlopCounterMode` over
  the benchmark's own reference (reference/) on the meta device: convs,
  transposed convs and matrix products, forward and, for PPO, backward.
  Work that a program repeats for its own reasons is counted once: the
  rollout's LPIPS reads the original frame's taps from the init. A
  configuration's reference module adds the work of what it brings past
  the five modules (`extra_flops`, check.py).
- `k1_bound_ms`: the least time of the UNet's conv3, conv4 and conv5 (the
  convs the port runs through its kernel K1) over the unit's UNet calls.
- `attn_bound_ms`: the least time of the unit's attention calls (K2 forward,
  K3 dq and K4 dk/dv), per call the larger of FLOPs over the bf16 peak and
  bytes (each operand read once, each output written once) over HBM.
- `launches`: the launches of each port kernel per unit, which the harness
  holds every run to.

Frozen copies of chip_smoke.py's `conv_bound` and `attention_cost` and the
published peaks of one NVIDIA H100 SXM (the data sheet's dense rates).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

import check
from reference import model as M

PEAK_BF16_FLOPS = 989e12    # H100 SXM, dense bf16
PEAK_BYTES = 3.35e12        # H100 SXM, HBM3


def conv_bound(b, h, w, cin, cout, peak=PEAK_BF16_FLOPS):
    """Least time (ms) of one 3x3 conv: operations over the peak rate, or
    each operand read once and the output written once over HBM (bf16
    activations and weights, f32 bias)."""
    flops = 2.0 * b * h * w * 9 * cin * cout
    nbytes = 2.0 * b * h * w * cin + 2.0 * 9 * cin * cout + 4.0 * cout \
        + 2.0 * b * h * w * cout
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops


def attention_cost(b, h, lq, lk, d):
    """(FLOPs, bytes) of each of K2, K3, K4 at one shape. FLOPs: 2 per
    multiply-add of the products (K2 two: S, PV; K3 three: S, dP, dQ; K4
    four: S^T, dP^T, dV, dK). Bytes: every input read once and every output
    written once (bf16 tensors, f32 LSE and delta)."""
    mm = 2.0 * b * h * lq * lk * d
    ql, kl, stat = 2.0 * b * h * lq * d, 2.0 * b * h * lk * d, 4.0 * b * h * lq
    flops = {"fwd": 2 * mm, "dq": 3 * mm, "dkv": 4 * mm}
    nbytes = {
        "fwd": 2 * ql + 2 * kl + stat,
        "dq": 3 * ql + 2 * kl + 2 * stat,
        "dkv": 2 * ql + 4 * kl + 2 * stat,
    }
    return flops, nbytes


def attention_bound_ms(b, h, l, d, kind: str) -> float:
    flops, nbytes = attention_cost(b, h, l, l, d)
    return max(flops[kind] / PEAK_BF16_FLOPS, nbytes[kind] / PEAK_BYTES) * 1e3


# ------------------------------------------------------------------ shapes

def _meta_params(cfg: dict) -> Dict[str, M.Params]:
    """Meta tensors of every weight the reference reads, by the shapes the
    configuration implies."""
    m = cfg["model"]
    c1, c2, c3, c4 = m["local_net_channels"]
    t = lambda *s: torch.empty(s, device="meta")        # noqa: E731
    unet = {}
    for name, cin, cout in (("conv1", 9, c1), ("conv2", c1, c2), ("conv3", c2, c3),
                            ("conv4", c3, c4), ("conv5", 2 * c3, c3), ("conv6", 2 * c2, c2),
                            ("conv7", 2 * c1, c1), ("conv8", c1, 3)):
        k = 1 if name == "conv8" else 3
        unet[f"{name}.weight"], unet[f"{name}.bias"] = t(cout, cin, k, k), t(cout)
    for name, cin, cout in (("upconv1", c4, c3), ("upconv2", c3, c2), ("upconv3", c2, c1)):
        unet[f"{name}.weight"], unet[f"{name}.bias"] = t(cin, cout, 2, 2), t(cout)
    stages = m["lpips_stages"] or M.VGG16_STAGES
    lp, cin = {}, 3
    for s, (f, n) in enumerate(stages):
        for c in range(n):
            lp[f"vgg.conv{s + 1}_{c + 1}.weight"], lp[f"vgg.conv{s + 1}_{c + 1}.bias"] = \
                t(f, cin, 3, 3), t(f)
            cin = f
        lp[f"lin{s}"] = t(f)
    vp = {}
    if m["backbone"] == "resnet50":
        def bn(name, f):
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                vp[f"backbone.{name}.{leaf}"] = t(f)
        vp["backbone.conv1.weight"] = t(64, 3, 7, 7)
        bn("bn1", 64)
        cin, f = 64, 64
        for stage, n in enumerate(M.RESNET50_BLOCKS):
            for blk in range(n):
                pre = f"layer{stage + 1}_{blk}"
                for j, (ci, co, k) in enumerate(((cin, f, 1), (f, f, 3), (f, 4 * f, 1))):
                    vp[f"backbone.{pre}.conv{j + 1}.weight"] = t(co, ci, k, k)
                    bn(f"{pre}.bn{j + 1}", co)
                if blk == 0:
                    vp[f"backbone.{pre}.conv_down.weight"] = t(4 * f, cin, 1, 1)
                    bn(f"{pre}.bn_down", 4 * f)
                cin = 4 * f
            f *= 2
        pooled = 2048
    else:
        cin = 3
        for i in range(3):
            f = 32 * 2 ** i
            vp[f"backbone.conv{i + 1}.weight"], vp[f"backbone.conv{i + 1}.bias"] = t(f, cin, 3, 3), t(f)
            cin = f
        pooled = cin
    vp["feat_head.weight"], vp["feat_head.bias"] = t(m["feature_dim"], pooled), t(m["feature_dim"])
    tile = m["canvas_tile"]
    vp["tile_head.weight"], vp["tile_head.bias"] = t(tile * tile, pooled), t(tile * tile)
    return {"vp": vp, "lpips": lp, "local_net": unet,
            "actor2": _policy_params(cfg, t, False), "critic2": _policy_params(cfg, t, True)}


def _policy_params(cfg, t, critic: bool) -> M.Params:
    m, rl = cfg["model"], cfg["rl"]
    s = m["pn2_num_frames"]
    p = {}
    if rl["context_policy"] == "attention":
        hd, nh, pt = m["attn_hidden_dim"], m["attn_heads"], m["attn_patch_tokens"]
        p["tokenize.weight"], p["tokenize.bias"] = t(m["feature_dim"], pt, hd), t(pt, hd)
        p["frame_pos"], p["patch_pos"], p["target_emb"] = t(s, 1, hd), t(1, pt, hd), t(hd)
        for i in range(m["attn_depth"]):
            sa = f"block{i}.SelfAttentionBlock_0"
            p[f"{sa}.LayerNorm_0.weight"], p[f"{sa}.LayerNorm_0.bias"] = t(hd), t(hd)
            for n in ("q", "k", "v"):
                p[f"{sa}.MultiHeadAttention_0.{n}.weight"] = t(hd, nh, hd // nh)
                p[f"{sa}.MultiHeadAttention_0.{n}.bias"] = t(nh, hd // nh)
            p[f"{sa}.MultiHeadAttention_0.out.weight"] = t(nh, hd // nh, hd)
            p[f"{sa}.MultiHeadAttention_0.out.bias"] = t(hd)
            ff = f"block{i}.FeedForwardBlock_0"
            p[f"{ff}.LayerNorm_0.weight"], p[f"{ff}.LayerNorm_0.bias"] = t(hd), t(hd)
            p[f"{ff}.Dense_0.weight"], p[f"{ff}.Dense_0.bias"] = t(hd // 4, hd), t(hd // 4)
            p[f"{ff}.Dense_1.weight"], p[f"{ff}.Dense_1.bias"] = t(hd, hd // 4), t(hd)
        head = "value_head" if critic else "head"
        p[f"{head}.weight"], p[f"{head}.bias"] = t(1, hd), t(1)
        return p
    cin = 1
    for i, f in enumerate(M.POLICY_TRUNK):
        p[f"convs.{i}.weight"], p[f"convs.{i}.bias"] = t(f, cin, 3, 3), t(f)
        p[f"norms.{i}.weight"], p[f"norms.{i}.bias"] = t(f), t(f)
        cin = f
    h = w = m["canvas_size"] // 32
    h, w = (h - 2) // 2 + 1, (w - 2) // 1 + 1
    h, w = (h - 2) // 2 + 1, (w - 2) // 2 + 1
    fin = M.POLICY_TRUNK[-1] * h * w + m["feature_dim"]
    for i, f in enumerate(tuple(m["pn2_fc_dims"]) + ((1 if critic else s),)):
        p[f"final_fc.{i}.weight"], p[f"final_fc.{i}.bias"] = t(f, fin), t(f)
        fin = f
    return p


def _count(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def flops(cfg: dict, kind: str, ref: str = check.DEFAULT_REFERENCE) -> float:
    """Model FLOPs of one unit ("train" step or "serve" batch) of a
    configuration whose reference module is `ref`."""
    m, rl = cfg["model"], cfg["rl"]
    W = _meta_params(cfg)
    P = M.Precision("f32")
    b, s, T = rl["batch_size"], rl["vid_length"], rl["time_steps"]
    h, w = cfg["data"]["frame_size"]
    stages = m["lpips_stages"] or M.VGG16_STAGES
    tile = m["canvas_tile"]
    pol = M.Policy(rl["context_policy"], m["attn_depth"], m["pn2_temperature"])
    x = lambda *shape: torch.empty(shape, device="meta")                # noqa: E731
    frames224 = x(b * s, 224, 224, 3)
    total = _count(lambda: M.vp_encode(P, W["vp"], frames224, m["backbone"], tile))
    if kind == "train":   # the reward's baseline: both clips through VGG once
        total += _count(lambda: M.vgg_taps(P, W["lpips"], x(2 * b * s, h, w, 3), stages))

    def obs(n):
        if rl["context_policy"] == "attention":
            return (x(n, s, m["feature_dim"]),)
        return (x(n, m["canvas_size"], m["canvas_size"], 1), x(n, m["feature_dim"]))

    tgt_b = torch.zeros(b, dtype=torch.long, device="meta")

    def step():
        pol.logits(P, W["actor2"], obs(b), tgt_b)
        M.unet(P, W["local_net"], x(b, h, w, 3), x(b, 2, h, w, 3))
        if kind == "train":
            M.vgg_taps(P, W["lpips"], x(b, h, w, 3), stages)
        M.vp_encode(P, W["vp"], x(b, 224, 224, 3), m["backbone"], tile)

    total += T * _count(step)
    if kind == "train":
        n = b * T
        tgt = torch.zeros(n, dtype=torch.long, device="meta")
        acs = torch.zeros(n, 2, dtype=torch.long, device="meta")
        noise = x(n, s)
        total += _count(lambda: pol.value(P, W["critic2"], obs(n), tgt))

        def epoch():
            pa = {k: v.requires_grad_(True) for k, v in W["actor2"].items()}
            pc = {k: v.requires_grad_(True) for k, v in W["critic2"].items()}
            la = pol.logprob(P, pa, obs(n), tgt, acs, noise).mean()
            torch.autograd.grad(la, list(pa.values()), allow_unused=True)
            lc = pol.value(P, pc, obs(n), tgt).mean()
            torch.autograd.grad(lc, list(pc.values()), allow_unused=True)

        total += rl["n_updates_per_ppo"] * _count(epoch)
    extra = getattr(check.reference(ref), "extra_flops", None)
    if extra is not None:
        total += extra(cfg, kind)
    return total


def unet_k1_bound_ms(cfg: dict) -> float:
    """K1's least time over one UNet call: conv3, conv4 and conv5 at the
    batch and frame size of the rollout."""
    b = cfg["rl"]["batch_size"]
    h, w = cfg["data"]["frame_size"]
    c1, c2, c3, c4 = cfg["model"]["local_net_channels"]
    shapes = ((h // 4, w // 4, c2, c3), (h // 8, w // 8, c3, c4), (h // 4, w // 4, 2 * c3, c3))
    return sum(conv_bound(b, hh, ww, ci, co)[0] for hh, ww, ci, co in shapes)


def unit(cfg: dict, kind: str, ref: str = check.DEFAULT_REFERENCE) -> dict:
    """The cell file's numbers for one unit of `kind` ("train" / "serve")."""
    m, rl = cfg["model"], cfg["rl"]
    b, T, s = rl["batch_size"], rl["time_steps"], rl["vid_length"]
    out = {"flops": flops(cfg, kind, ref), "k1_bound_ms": T * unet_k1_bound_ms(cfg),
           "launches": {"K1": 3 * T, "K2": 0, "K3": 0, "K4": 0}}
    if rl["context_policy"] == "attention":
        depth, heads = m["attn_depth"], m["attn_heads"]
        l, d = s * m["attn_patch_tokens"], m["attn_hidden_dim"] // heads
        k2_roll = T * depth
        bound = k2_roll * attention_bound_ms(b, heads, l, d, "fwd")
        out["launches"]["K2"] = k2_roll
        if kind == "train":
            n, e = b * T, rl["n_updates_per_ppo"]
            k2_ppo = depth + 2 * e * depth    # the values before the epochs; actor, critic each epoch
            k34 = 2 * e * depth                # the actor's and the critic's backward each epoch
            bound += k2_ppo * attention_bound_ms(n, heads, l, d, "fwd")
            bound += k34 * (attention_bound_ms(n, heads, l, d, "dq")
                            + attention_bound_ms(n, heads, l, d, "dkv"))
            out["launches"].update(K2=k2_roll + k2_ppo, K3=k34, K4=k34)
        out["attn_bound_ms"] = bound
    return out
