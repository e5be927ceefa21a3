"""The port's reference-checkpoint converters (models/*.convert_*,
utils/convert.py) and the CLI's `convert` -> `--warm_start`, on the CPU.

Reference-layout state dicts are made from a seed with the reference's key
names (torchvision resnet50 and raft_small, pip lpips' VGG, the reference
UNet and PolicyNetwork2), shaped as the port module's tensors; the widths
are cut where the JAX converter reads them from the state dict. Each port
converter must equal `module_params_from_jax(<the JAX converter's output>)`
exactly and load strictly into its module; the port module then computes
the JAX module's forward at f32 within the ROADMAP tolerances (2e-5/1e-4
for the UNet, 1e-4/1e-3 for ResNet-50 and LPIPS, 1e-4 for the policy, RAFT
within 1e-4 of its largest flow). A missing key raises. `convert` writes a
directory that `rl --warm_start` plugs in bit for bit and that `eval
--warm_start` reads, the provenance gate deciding from what was loaded.
"""

import dataclasses
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from rovr_tpu.models import local_net as jln
from rovr_tpu.models import policy_net_2 as jpn2
from rovr_tpu.models import raft as jraft
from rovr_tpu.models import resnet as jrn
from rovr_tpu.models import vgg_lpips as jvl
from rovr_tpu.utils import convert as jconvert
from rovr_torch import cli as tcli
from rovr_torch.config import from_dict
from rovr_torch.models import local_net as tln
from rovr_torch.models import policy_net_2 as tpn2
from rovr_torch.models import raft as traft
from rovr_torch.models import resnet as trn
from rovr_torch.models import vgg_lpips as tvl
from rovr_torch.train import rl
from rovr_torch.utils import convert
from rovr_torch.utils.convert import module_params_from_jax

JF, TF = jnp.float32, torch.float32
UNET_CH = (8, 16, 32, 64)
VGG_NARROW = ((8, 2), (8, 2), (16, 3), (16, 3), (16, 3))   # VGG16's plan, narrow
PN2_KW = dict(num_frames=6, fc_dims=(64, 32, 16, 8))       # five final_fc layers


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _draw(name: str, shape, rng) -> torch.Tensor:
    """A plausible value for the tensor the port calls `name`: positive
    variances, norm scales near 1, small biases, lecun-scaled kernels,
    LPIPS' non-negative heads."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "running_var":
        a = rng.uniform(0.5, 2.0, shape)
    elif leaf == "running_mean":
        a = rng.uniform(-0.5, 0.5, shape)
    elif name.startswith("lin"):
        a = rng.uniform(0.0, 0.1, shape)
    elif len(shape) == 1 and leaf == "weight" and re.search(r"(^|\.)(bn|norm)", name):
        a = rng.uniform(0.5, 1.5, shape)
    elif len(shape) == 1:
        a = rng.uniform(-0.1, 0.1, shape)
    else:
        a = rng.standard_normal(shape) / math.sqrt(np.prod(shape[1:]))
    return torch.from_numpy(np.asarray(a, np.float32))


def _ref_resnet(name):
    name = re.sub(r"layer(\d)_(\d+)", r"layer\1.\2", name)
    return name.replace("conv_down", "downsample.0").replace("bn_down", "downsample.1")


def _ref_raft(name):
    name = name.replace("fnet.", "feature_encoder.").replace("cnet.", "context_encoder.")
    name = re.sub(r"layer(\d)_(\d)\.conv(\d)", r"layer\1.\2.convnormrelu\3.0", name)
    name = re.sub(r"layer(\d)_(\d)\.norm(\d)", r"layer\1.\2.convnormrelu\3.1", name)
    name = re.sub(r"layer(\d)_(\d)\.conv_down", r"layer\1.\2.downsample.0", name)
    name = re.sub(r"layer(\d)_(\d)\.norm_down", r"layer\1.\2.downsample.1", name)
    name = re.sub(r"encoder\.conv1\.", "encoder.convnormrelu.0.", name)
    name = re.sub(r"encoder\.norm1\.", "encoder.convnormrelu.1.", name)
    name = re.sub(r"encoder\.conv2\.", "encoder.conv.", name)
    for port, ref in (("motion.convc1", "motion_encoder.convcorr1.0"),
                      ("motion.convf1", "motion_encoder.convflow1.0"),
                      ("motion.convf2", "motion_encoder.convflow2.0"),
                      ("motion.conv.", "motion_encoder.conv.0."),
                      ("gru.", "recurrent_block.convgru."), ("update.", "update_block.")):
        name = name.replace(port, ref)
    return name


def _ref_lpips(name, shape):
    m = re.fullmatch(r"vgg\.conv(\d)_(\d)\.(\w+)", name)
    if m:
        s, c, leaf = int(m.group(1)), int(m.group(2)), m.group(3)
        return f"net.slice{s}.{tvl._VGG16_CONVS[s - 1][c - 1]}.{leaf}", shape
    return f"{name}.model.1.weight", (1,) + tuple(shape) + (1, 1)


def _ref_pn2(name):
    m = re.fullmatch(r"(convs|norms)\.(\d)\.(\w+)", name)
    if m:
        return f"video_conv.{4 * int(m.group(2)) + (m.group(1) == 'norms')}.{m.group(3)}"
    return name


MODULES = {
    "local_net": lambda: tln.LocalNetUNet(channels=UNET_CH, dtype=TF),
    "policy2": lambda: tpn2.PolicyNet2(dtype=TF, **PN2_KW),
    "resnet50": lambda: trn.ResNet50(dtype=TF),
    "vgg_lpips": lambda: tvl.LPIPS(dtype=TF, stages=VGG_NARROW),
    "raft": lambda: traft.RAFTSmall(iters=2, dtype=TF),
}


def reference_state_dict(kind: str, seed: int = 0) -> dict:
    """A seeded state dict in the reference's layout for `kind`, with the
    entries the converters drop (dead or running BatchNorm statistics, the
    classifier) included."""
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in MODULES[kind]().state_dict().items()}
    sd = {}
    for port_name, shape in shapes.items():
        value = _draw(port_name, shape, rng)
        name = port_name
        if kind == "resnet50":
            name = _ref_resnet(name)
        elif kind == "raft":
            name = _ref_raft(name)
        elif kind == "vgg_lpips":
            name, shape = _ref_lpips(name, shape)
            value = value.reshape(shape)
        elif kind == "policy2":
            name = _ref_pn2(name)
        sd[name] = value
    if kind == "local_net":      # the reference's BatchNorms, never applied
        sd.update({f"bn{i}.weight": torch.ones(4) for i in range(1, 4)})
    if kind == "policy2":
        for seq in (1, 5, 9, 13):
            c = sd[f"video_conv.{seq}.weight"].shape
            sd[f"video_conv.{seq}.running_mean"] = _draw("running_mean", c, rng)
            sd[f"video_conv.{seq}.running_var"] = _draw("running_var", c, rng)
            sd[f"video_conv.{seq}.num_batches_tracked"] = torch.tensor(3)
    if kind == "resnet50":
        sd["fc.weight"], sd["fc.bias"] = torch.zeros(10, 2048), torch.zeros(10)
        sd.update({k.replace("running_var", "num_batches_tracked"): torch.tensor(3)
                   for k in list(sd) if k.endswith("running_var")})
    return sd


def _both(kind: str, sd: dict):
    """(the port converter's state dict, the JAX converter's tree)."""
    np_sd = {k: v.numpy() for k, v in sd.items()}
    if kind == "vgg_lpips":
        vgg, lins = convert._lpips_package_to_converter_inputs(sd)
        jvgg, jlins = jconvert._lpips_package_to_converter_inputs(np_sd)
        return tvl.convert_lpips_weights(vgg, lins), jvl.convert_lpips_weights(jvgg, jlins)
    port = {"local_net": tln.convert_torch_state_dict, "policy2": tpn2.convert_torch_state_dict,
            "resnet50": trn.convert_torch_state_dict, "raft": traft.convert_raft_state_dict}
    ref = {"local_net": jln.convert_torch_state_dict, "policy2": jpn2.convert_torch_state_dict,
           "resnet50": jrn.convert_torch_state_dict, "raft": jraft.convert_raft_state_dict}
    return port[kind](sd), ref[kind](np_sd)


@pytest.fixture(scope="module")
def converted():
    out = {}
    for kind in MODULES:
        sd = reference_state_dict(kind)
        port, jtree = _both(kind, sd)
        out[kind] = (sd, port, jtree)
    return out


@pytest.mark.parametrize("kind", sorted(MODULES))
def test_converter_equals_the_jax_converter(converted, kind):
    sd, port, jtree = converted[kind]
    via_jax = module_params_from_jax(jtree)
    assert set(port) == set(via_jax)
    for k in port:
        np.testing.assert_array_equal(port[k].numpy(), via_jax[k].numpy(), err_msg=k)
    MODULES[kind]().load_state_dict(port, strict=True)
    missing = dict(sd)
    missing.pop(next(k for k in sd if k.endswith("weight") and sd[k].ndim == 4))
    with pytest.raises(KeyError):
        _both(kind, missing)


def _u(seed, *shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("kind", sorted(MODULES))
def test_converted_forward_matches_jax(converted, kind):
    _, port, jtree = converted[kind]
    tm = MODULES[kind]()
    tm.load_state_dict(port, strict=True)
    tm.eval()
    with torch.no_grad():
        if kind == "local_net":
            tgt, ctx = _u(1, 2, 32, 32, 3), _u(2, 2, 2, 32, 32, 3)
            want = jln.LocalNetUNet(channels=UNET_CH, dtype=JF).apply(
                {"params": jtree}, jnp.asarray(tgt), jnp.asarray(ctx))
            got = tm(torch.from_numpy(tgt), torch.from_numpy(ctx))
            tol = dict(atol=2e-5, rtol=1e-4)
        elif kind == "policy2":
            canvas, feat = _u(3, 4, 160, 160, 1), _u(4, 4, 1024)
            tgt = np.array([0, 3, 5, 2], np.int32)
            want = jpn2.PolicyNet2(dtype=JF, **PN2_KW).apply(
                {"params": jtree}, jnp.asarray(canvas), jnp.asarray(feat), jnp.asarray(tgt),
                method=jpn2.PolicyNet2.masked_logits)
            got = tm.masked_logits(torch.from_numpy(canvas), torch.from_numpy(feat),
                                   torch.from_numpy(tgt).long())
            tol = dict(atol=1e-4, rtol=1e-4)
        elif kind == "resnet50":
            x = _u(5, 1, 32, 32, 3)
            want = jrn.ResNet50(dtype=JF).apply({"params": jtree}, jnp.asarray(x))
            got = tm(torch.from_numpy(x))
            tol = dict(atol=1e-4, rtol=1e-3)
        elif kind == "vgg_lpips":
            x, y = _u(6, 2, 32, 32, 3), _u(7, 2, 32, 32, 3)
            want = jvl.LPIPS(dtype=JF, stages=VGG_NARROW).apply(
                {"params": jtree}, jnp.asarray(x), jnp.asarray(y))
            got = tm(torch.from_numpy(x), torch.from_numpy(y))
            tol = dict(atol=1e-4, rtol=1e-3)
        else:
            a, b = _u(8, 1, 64, 64, 3), _u(9, 1, 64, 64, 3)
            want = jax.jit(jraft.RAFTSmall(iters=2, dtype=JF).apply)(
                {"params": jtree}, jnp.asarray(a), jnp.asarray(b))
            got = tm(torch.from_numpy(a), torch.from_numpy(b))
            tol = dict(atol=1e-4 * float(np.abs(np.asarray(want)).max()), rtol=0)
    assert np.isfinite(np.asarray(want)).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _tiny_cfg():
    c = _tiny_config(batch_size=2)
    return from_dict(dataclasses.asdict(c.replace(model=dataclasses.replace(
        c.model, backbone="tiny", lpips_stages=VGG_NARROW, local_net_channels=UNET_CH,
        pn2_fc_dims=PN2_KW["fc_dims"], pn2_num_frames=5, canvas_size=160,
        canvas_tiles_per_row=5))))


def test_convert_then_warm_start_round_trip(tmp_path, monkeypatch, capsys, converted):
    """`convert --kind rovr` of a full reference state (its envelope and
    prefixes) writes a directory whose state dicts `rl --warm_start` plugs
    into the first step's state bit for bit; `eval --warm_start` with
    lpips and raft converted into one directory loads both metric nets, so
    Eval/metric_weights_random reads 0 and nothing is withheld; with lpips
    only, the weight-dependent metrics are withheld."""
    cfg = _tiny_cfg()
    monkeypatch.setattr(tcli, "Config", lambda: cfg)
    shapes = {name: {k: tuple(v.shape) for k, v in mod.state_dict().items()}
              for name, mod in (("local_net", tln.LocalNetUNet(channels=UNET_CH, dtype=TF)),
                                ("pn2", tpn2.PolicyNet2(dtype=TF, num_frames=5,
                                                        fc_dims=PN2_KW["fc_dims"])))}
    rng = np.random.default_rng(4)
    full = {f"local_net.{k}": _draw(k, s, rng) for k, s in shapes["local_net"].items()}
    for prefix in ("actor2", "critic2"):
        for k, s in shapes["pn2"].items():
            if prefix == "critic2" and k.startswith("final_fc.4"):
                s = (1,) + s[1:]    # the critic's single output
            full[f"{prefix}.{_ref_pn2(k)}"] = _draw(k, s, rng)
    lp_sd = converted["vgg_lpips"][0]
    full.update({f"lpips.{k}": v for k, v in lp_sd.items()})
    cell = torch.nn.LSTMCell(6, 4)
    full.update({f"history_encoder.lstm.{k}": v for k, v in cell.state_dict().items()})
    torch.save({"epoch": 3, "model_state_dict": full}, tmp_path / "rovr.pt")
    out = tmp_path / "warm"
    assert tcli.main(["convert", "--kind", "rovr", "--ckpt", str(tmp_path / "rovr.pt"),
                      "--out", str(out)]) == 0
    printed = capsys.readouterr().out
    for name in ("local_net_params", "actor2_params", "critic2_params", "lpips_params",
                 "lstm_cell_params"):
        assert f"[convert] converted: {name}" in printed
    loaded = convert.load_converted(str(out))
    want, _ = convert.convert_reference_checkpoint("rovr", str(tmp_path / "rovr.pt"))
    assert set(loaded) == set(want)

    seen = []
    real_init = rl.init_state
    monkeypatch.setattr(rl, "init_state", lambda *a, **kw: seen.append(real_init(*a, **kw))
                        or seen[-1])
    assert tcli.main(["rl", "--warm_start", str(out), "--iterations", "1", "--batch_size", "2",
                      "--vid_length", "5", "--time_steps", "4", "--n_updates_per_ppo", "1",
                      "--run_dir", str(tmp_path / "runs"), "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "[warm_start] skipping lstm_cell_params" in printed
    state = seen[0]
    for field in ("local_net_params", "actor2_params", "critic2_params", "lpips_params"):
        got = getattr(state, field)
        assert set(got) == set(want[field])
        for k, v in want[field].items():
            assert torch.equal(got[k], v), (field, k)

    # eval: raft converted into the same directory as lpips (convert keeps both)
    raft_sd = converted["raft"][0]
    torch.save(raft_sd, tmp_path / "raft.pt")
    metric_dir = tmp_path / "metric"
    torch.save({f"{k}": v for k, v in lp_sd.items()}, tmp_path / "lpips.pt")
    assert tcli.main(["convert", "--kind", "vgg_lpips", "--ckpt", str(tmp_path / "lpips.pt"),
                      "--out", str(metric_dir)]) == 0
    eval_argv = ["eval", "--warm_start", str(metric_dir), "--num_videos", "2",
                 "--vid_length", "5", "--flow_size", "64", "--run_dir",
                 str(tmp_path / "runs"), "--device", "cpu"]
    means = []
    from rovr_torch.train import evaluate
    real_run = evaluate.run
    monkeypatch.setattr(evaluate, "run", lambda *a, **kw: means.append(real_run(*a, **kw))
                        or means[-1])
    capsys.readouterr()
    assert tcli.main(eval_argv) == 0
    assert means[-1]["Eval/metric_weights_random"] == 1.0
    assert "weight-dependent metrics withheld" in capsys.readouterr().out
    assert tcli.main(["convert", "--kind", "raft", "--ckpt", str(tmp_path / "raft.pt"),
                      "--out", str(metric_dir)]) == 0
    assert "keeping from" in capsys.readouterr().out
    assert tcli.main(eval_argv) == 0
    printed = capsys.readouterr().out
    assert "plugging in: lpips_params, raft_params" in printed
    assert means[-1]["Eval/metric_weights_random"] == 0.0
    assert "withheld" not in printed and "Eval/lpips_agentic" in printed


def test_wrong_kind_and_orbax_directories(tmp_path, capsys):
    torch.save(reference_state_dict("local_net"), tmp_path / "unet.pt")
    assert tcli.main(["convert", "--kind", "raft", "--ckpt", str(tmp_path / "unet.pt"),
                      "--out", str(tmp_path / "o")]) == 1
    assert "skipped: raft_params: KeyError" in capsys.readouterr().out
    orbax = tmp_path / "orbax" / "0" / "default"
    orbax.mkdir(parents=True)
    (orbax / "_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="cannot be read without JAX"):
        convert.load_converted(str(tmp_path / "orbax"))
    vp = {"backbone.conv1.weight": torch.zeros(1), "heads.w": torch.ones(1)}
    merged = convert.merge_vp_backbone(vp, {"conv1.weight": torch.ones(1)})
    assert set(merged) == set(vp) and torch.equal(merged["backbone.conv1.weight"],
                                                  torch.ones(1))
