"""Plain float32 reference of a ROVR episode and its PPO update.

`Ref` holds a configuration's numbers (read from the configuration file's
plain dict) and the weights the benchmark drew, and computes:

- `init`: the per-frame LPIPS of the corrupted clip against the original
  (the reward's baseline), the original frames' VGG taps that the rewards
  read, and the VideoProcessor's canvas and frame features, in blocks of
  frames;
- `rollout`: T steps with target t mod S, each the policy's scores, a pair
  of context frames, the UNet's frame, its LPIPS reward and the re-encoded
  tile. Given `actions` it follows them (a program's pairs, judged here);
  without them it picks its own (the top two, with the Gumbel noise when
  training, greedily when serving);
- `ppo`: the advantage from the rewards-to-go and the critic, then the
  epochs of a PPO-clip actor step and a critic step, each with Adam.

Nothing here reads what a program computed, except the pairs it is told to
follow.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import model as M

INIT_BLOCK = 16      # frames per block of the init's LPIPS and encode passes


class Ref:
    def __init__(self, cfg: dict, weights: Dict[str, M.Params], precision: str = "f32"):
        """`cfg`: the configuration file's "config" dict; `weights`: module
        name ("vp", "lpips", "local_net", "actor2", "critic2") -> params."""
        self.P = M.Precision(precision)
        m, rl = cfg["model"], cfg["rl"]
        self.w = weights
        self.T, self.S = rl["time_steps"], rl["vid_length"]
        self.epochs, self.clip = rl["n_updates_per_ppo"], rl["clip"]
        self.gamma, self.lr = rl["gamma"], (rl["actor_lr"], rl["critic_lr"])
        self.backbone, self.tile = m["backbone"], m["canvas_tile"]
        self.canvas, self.per_row = m["canvas_size"], m["canvas_tiles_per_row"]
        self.stages = [tuple(s) for s in (m["lpips_stages"] or M.VGG16_STAGES)]
        self.policy = M.Policy(rl["context_policy"], m["attn_depth"], m["pn2_temperature"])

    # ------------------------------------------------------------ episode

    def encode(self, frames: torch.Tensor):
        """frames (N, H, W, 3) -> (tiles, feats) of the VideoProcessor."""
        return M.vp_encode(self.P, self.w["vp"], M.resize224(frames), self.backbone, self.tile)

    def taps(self, frames: torch.Tensor) -> List[torch.Tensor]:
        return M.vgg_taps(self.P, self.w["lpips"], frames, self.stages)

    @torch.no_grad()
    def init(self, video: torch.Tensor, org: Optional[torch.Tensor]):
        """(curr_loss (B, S) or None, the original frames' taps (per stage
        (B, S, c, h, w)) or None, canvas (B, C, C, 1), feats (B, S, F))."""
        b, s = video.shape[:2]
        flat = video.reshape((b * s,) + video.shape[2:])
        curr = org_taps = None
        if org is not None:
            oflat = org.reshape(flat.shape)
            curr = video.new_empty(b * s)
            for i in range(0, b * s, INIT_BLOCK):
                o = self.taps(oflat[i:i + INIT_BLOCK])
                if org_taps is None:    # filled block by block: no second copy
                    org_taps = [x.new_empty((b * s,) + x.shape[1:]) for x in o]
                for dst, x in zip(org_taps, o):
                    dst[i:i + len(x)] = x
                curr[i:i + len(o[0])] = M.lpips_from_taps(
                    self.w["lpips"], self.taps(flat[i:i + INIT_BLOCK]), o)
            curr = curr.reshape(b, s)
            org_taps = [x.reshape((b, s) + x.shape[1:]) for x in org_taps]
        enc = [self.encode(flat[i:i + INIT_BLOCK]) for i in range(0, b * s, INIT_BLOCK)]
        tiles = torch.cat([e[0] for e in enc]).reshape(b, s, self.tile, self.tile)
        feats = torch.cat([e[1] for e in enc]).reshape(b, s, -1)
        return curr, org_taps, M.canvas_of(tiles, self.canvas, self.per_row)[..., None], feats

    @torch.no_grad()
    def rollout(self, video, org=None, gumbel=None, actions=None) -> dict:
        """One episode over float clips (B, S, H, W, 3) in [0, 1]. `org`
        None: no rewards (serving). `gumbel` (T, B, S) or None (greedy).
        `actions` (T, B, 2): the pairs to follow; None: pick them.

        Returns the pairs and their logprobs (T, B[, 2]), `choice_gap` (T, B):
        how far the followed pair's score lies below this policy's best
        pair, the reconstruction (B, S, H, W, 3), the observations, and with
        rewards the marginal rewards (T, B), per-step LPIPS and MSE, and the
        rewards-to-go."""
        b, s = video.shape[:2]
        dev = video.device
        ar = torch.arange(b, device=dev)
        curr, org_taps, canvas, feats = self.init(video, org)
        recon = video.float().clone()
        out = {k: [] for k in ("acs", "logp", "gap", "obs", "tgt", "marginal", "lpips", "mse")}
        for t in range(self.T):
            tgt = torch.full((b,), t % s, dtype=torch.long, device=dev)
            obs = (feats,) if self.policy.kind == "attention" else (canvas, feats[ar, tgt])
            scores = self.policy.scores(self.P, self.w["actor2"], obs, tgt,
                                        None if gumbel is None else gumbel[t])
            best, best_lp = M.top2(scores)
            acs = best if actions is None else actions[t].to(dev).long()
            lp = scores.gather(1, acs).sum(1) / 2 + M.LN2
            y = M.unet(self.P, self.w["local_net"], video[ar, tgt], video[ar[:, None], acs])
            if org is not None:
                o = org[ar, tgt]
                now = M.lpips_from_taps(self.w["lpips"], self.taps(y),
                                        [x[ar, tgt] for x in org_taps])
                out["marginal"].append(curr[ar, tgt] - now)
                curr[ar, tgt] = now
                out["lpips"].append(now)
                out["mse"].append(((y - o) ** 2).mean((1, 2, 3)))
            recon[ar, tgt] = y
            tiles, new_feat = self.encode(y)
            canvas = M.put_tile(canvas[..., 0], tgt, tiles, self.per_row)[..., None]
            if self.policy.kind == "attention":
                feats = feats.clone()
                feats[ar, tgt] = new_feat
            for k, v in (("acs", acs), ("logp", lp), ("gap", best_lp - lp), ("obs", obs),
                         ("tgt", tgt)):
                out[k].append(v)
        res = {"actions": torch.stack(out["acs"]), "logp": torch.stack(out["logp"]),
               "choice_gap": torch.stack(out["gap"]), "recon": recon,
               "obs": [torch.stack(x) for x in zip(*out["obs"])],
               "tgt": torch.stack(out["tgt"])}
        if org is not None:
            marginal = torch.stack(out["marginal"])
            rtgs = torch.empty_like(marginal)
            carry = torch.zeros_like(marginal[0])
            for t in range(self.T - 1, -1, -1):
                carry = marginal[t] + self.gamma * carry
                rtgs[t] = carry
            res.update(marginal=marginal, rtgs=rtgs, metrics={
                "lpips_loss": torch.stack(out["lpips"]).mean(),
                "mse_loss": torch.stack(out["mse"]).mean(),
                "mean_reward": marginal.mean()})
        return res

    # ---------------------------------------------------------------- PPO

    def ppo(self, traj: dict, gumbel: torch.Tensor, opt: dict) -> dict:
        """The PPO update over the episode `traj` (rows ordered clip-major,
        b * T + t), with the actor's noise `gumbel` (epochs, B*T, S) and the
        Adam states `opt` {"actor2": {step, m, v}, "critic2": ...}. Returns
        the new params, the Adam states, the last epoch's losses and every
        epoch's (`epoch_losses`)."""
        def flat(x):
            return x.transpose(0, 1).reshape((-1,) + tuple(x.shape[2:]))

        obs = [flat(x) for x in traj["obs"]]
        tgt, acs = flat(traj["tgt"]), flat(traj["actions"])
        old, rtgs = flat(traj["logp"]), flat(traj["rtgs"])
        pa = {k: v.detach().clone().requires_grad_(True) for k, v in self.w["actor2"].items()}
        pc = {k: v.detach().clone().requires_grad_(True) for k, v in self.w["critic2"].items()}
        with torch.no_grad():
            a = rtgs - self.policy.value(self.P, pc, obs, tgt)
            adv = (a - a.mean()) / (a.std(correction=1) + 1e-10)
        state = {n: {"step": opt[n]["step"], "m": dict(opt[n]["m"]), "v": dict(opt[n]["v"])}
                 for n in ("actor2", "critic2")}
        losses = {"actor": [], "critic": []}
        for e in range(self.epochs):
            lp = self.policy.logprob(self.P, pa, obs, tgt, acs, gumbel[e])
            ratio = torch.exp(torch.clamp(lp - old, -20.0, 20.0))
            a_loss = -torch.minimum(ratio * adv,
                                    torch.clamp(ratio, 1 - self.clip, 1 + self.clip) * adv).mean()
            adam(pa, a_loss, state["actor2"], self.lr[0])
            c_loss = ((self.policy.value(self.P, pc, obs, tgt) - rtgs) ** 2).mean()
            adam(pc, c_loss, state["critic2"], self.lr[1])
            losses["actor"].append(a_loss.item())
            losses["critic"].append(c_loss.item())
        return {"actor2": {k: v.detach() for k, v in pa.items()},
                "critic2": {k: v.detach() for k, v in pc.items()},
                "opt": state, "actor_loss": a_loss.detach(), "critic_loss": c_loss.detach(),
                "epoch_losses": losses}


def adam_state(params: M.Params) -> dict:
    return {"step": 0, "m": {k: torch.zeros_like(v) for k, v in params.items()},
            "v": {k: torch.zeros_like(v) for k, v in params.items()}}


def adam(params: M.Params, loss: torch.Tensor, st: dict, lr: float,
         b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """One Adam step on `params` (leaves that require grad) in place; a
    parameter the loss does not reach gets a zero gradient."""
    names = list(params)
    grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
    st["step"] += 1
    c1, c2 = 1 - b1 ** st["step"], 1 - b2 ** st["step"]
    with torch.no_grad():
        for n, g in zip(names, grads):
            g = torch.zeros_like(params[n]) if g is None else g
            st["m"][n] = b1 * st["m"][n] + (1 - b1) * g
            st["v"][n] = b2 * st["v"][n] + (1 - b2) * g * g
            params[n] -= lr / c1 * st["m"][n] / (torch.sqrt(st["v"][n] / c2) + eps)
