"""The comparison that decides `correct`, and the control that must fail it.

A program's record of a train cell is what its first three steps produced
(the set-up's steps, through the window's own call and feed) and what one
step of the window produced (`drive.window_step`): per step the context
pairs and their logprobs from the rollout, every PPO epoch's actor and
critic loss and the critic's targets, the step's metrics and its
reconstruction; the actor's and critic's parameters after step 3, and
their parameters and Adam states before and after the window's step. The
pairs are read from the actor's `act`, the losses and targets from
`rl.actor_loss` and `rl.value_loss`, through wrappers that store what those
return (program.py). The reference follows the three steps from the
benchmark's weights, clips and noise, and the window's step from the
policies as the program held them before it (the window's step comes after
steps that the reference does not follow, so it starts from the program's
own state there), each time along the program's pairs. Each number is read
against it; "the steps from equal policies" are step 1 and the window's:

- `logp_gap`: the largest |logprob| gap of a followed pair in the steps
  from equal policies (the init's features, the policy and its attention,
  the re-encoded features);
- `frame_gap`: the largest gap of a reconstructed pixel in [0, 1] over the
  four steps (the UNet);
- `reward_gap`: the largest gap of a step's mean LPIPS or mean reward,
  over the reference's mean LPIPS, over the four steps (LPIPS, the init's
  baseline);
- `target_gap`: the largest gap of a row's rewards-to-go as PPO's critic
  got them, over the largest in the reference, over the four steps (a row
  missing reads 1);
- `actor_loss_gap`: the largest gap of the first epoch's PPO actor loss in
  the steps from equal policies (its advantages are standardized, so the
  gap is taken as it is): a loss over part of the rows reads here;
- `update_gap`: of each leaf's change, after step 3 and over the window's
  step, the gap of the norms over the larger of the reference's norm and
  the median leaf's; the median leaf, the larger of the actor's and the
  critic's, and of the two changes;
- read, and not held to a limit (PERF.md gives their readings):
  `logp_later`, the logprob gap of steps 2 and 3, where the two sides'
  policies differ by Adam's rounding; `critic_loss_gap`, the first
  epoch's critic loss gap over the reference's, in the steps from equal
  policies.

A cell's file (cells/<cell>.json) holds the limit of each number it holds.
What is read after an Adam step is held at the median leaf because Adam
moves each element by about lr whatever its gradient's size: an element
whose gradient is nought to rounding steps either way on the two sides, and
within the five epochs of a step those steps feed every later gradient.
Leaves whose reference first moment after step 1 is under a thousandth of
the median leaf's are left out of `update_gap` (the key biases, which
softmax cancels).

A served batch's record is the uint8 frames and the pairs it handed back;
the reference follows the pairs greedily: `choice_gap`, the largest amount
by which a followed pair's score lies below the reference's best pair,
`choice_mean`, that amount's mean over every step and clip, and
`frame_lsb`, the largest gap of an output byte.

The reference is the module `reference/<name>.py` that the configuration
file names under "reference" (`episode` where it names none). It gives
`Ref` and `adam_state`, and may give: `POLICIES`, the policies the
configuration trains (actor2 and critic2 where it gives none), whose
parameters and Adam states are recorded and followed; `EXTRA_METRICS`,
further program metrics a train record keeps, under their full names
(`Episode/spatio`); `extra_numbers(steps)`, further numbers from each
followed step's (program record, reference record), its `metrics` holding
every metric the reference's rollout returned; `extra_flops(cfg, kind)`,
the model FLOPs of a unit past those work.py counts. An extra number is
judged as any other, by a limit in the cell's file.
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Dict, List, Optional

import torch

DEFAULT_REFERENCE = "episode"
DEFAULT_POLICIES = ("actor2", "critic2")
TRAIN_NUMBERS = ("logp_gap", "logp_later", "frame_gap", "reward_gap", "target_gap",
                 "actor_loss_gap", "critic_loss_gap", "update_gap")
SERVE_NUMBERS = ("choice_gap", "choice_mean", "frame_lsb")
SMALL_LEAF = 1e-3


def reference(name: str = DEFAULT_REFERENCE):
    """The reference module `reference/<name>.py`."""
    return importlib.import_module(f"reference.{name}")


def policies(ref: str = DEFAULT_REFERENCE) -> tuple:
    """The policies a configuration with reference `ref` trains."""
    return getattr(reference(ref), "POLICIES", DEFAULT_POLICIES)


@contextlib.contextmanager
def full_f32():
    """float32 products without TF32 for the block."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _clip(u8: torch.Tensor) -> torch.Tensor:
    return u8.float() / 255.0


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: v.float().norm().item() for k, v in tree.items()}


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep) -> Dict[str, float]:
    """Per leaf |‖prog‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖)."""
    med = sorted(ref.values())[len(ref) // 2]
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keep}


def _ref_record(r: dict, p: dict) -> dict:
    return {"pairs": r["actions"], "logp": r["logp"], "recon": r["recon"],
            "targets": r["rtgs"].transpose(0, 1).reshape(-1),
            "metrics": {**{k: v.item() for k, v in r["metrics"].items()},
                        "actor_loss": p["actor_loss"].item(),
                        "critic_loss": p["critic_loss"].item()},
            "epoch_losses": p["epoch_losses"]}


def reference_train(cfg: dict, weights: dict, feed: List[dict], follow=None,
                    precision: str = "f32", ref: str = DEFAULT_REFERENCE) -> List[dict]:
    """The reference's three steps as a record (`follow`: a record whose
    pairs it takes; None: it picks its own, as a program would)."""
    R, names = reference(ref), policies(ref)
    model = R.Ref(cfg, {k: dict(v) for k, v in weights.items()}, precision)
    opt = {n: R.adam_state(weights[n]) for n in names}
    out = []
    for i, item in enumerate(feed):
        g_roll, g_ppo = item["gumbel"]
        r = model.rollout(_clip(item["video"]), _clip(item["org"]), g_roll,
                          None if follow is None else follow[i]["pairs"])
        p = model.ppo(r, g_ppo, opt)
        opt = p["opt"]
        model.w.update({n: p[n] for n in names})
        rec = _ref_record(r, p)
        if i == 0:
            rec["moments"] = {n: dict(opt[n]["m"]) for n in names}
        out.append(rec)
    out[-1]["params"] = {n: dict(model.w[n]) for n in names}
    return out


def reference_window(cfg: dict, weights: dict, window: dict,
                     ref: str = DEFAULT_REFERENCE) -> dict:
    """The reference's step from the policies and Adam states as the
    program held them before its window's step (`window["before"]`), on
    that step's batch and noise, along its pairs."""
    names, before = policies(ref), window["before"]
    w = {**weights, **{n: dict(before[n]["params"]) for n in names}}
    opt = {n: {"step": before[n]["step"], "m": dict(before[n]["m"]), "v": dict(before[n]["v"])}
           for n in names}
    item = window["item"]
    g_roll, g_ppo = item["gumbel"]
    model = reference(ref).Ref(cfg, w)
    r = model.rollout(_clip(item["video"]), _clip(item["org"]), g_roll,
                      window["record"]["pairs"])
    p = model.ppo(r, g_ppo, opt)
    return {**_ref_record(r, p), "params": {n: p[n] for n in names}}


def _update_gap(w0: dict, prog: dict, ref: dict, keep) -> Dict[str, float]:
    """Per leaf, the gap of the norms of the change from `w0`."""
    dp = _norms({k: prog[k].to(w0[k]) - w0[k] for k in w0})
    dr = _norms({k: ref[k] - w0[k] for k in w0})
    return _leaf_gaps(dp, dr, keep)


def compare_train(cfg: dict, weights: dict, feed: List[dict], prog: List[dict],
                  window: Optional[dict] = None, detail: Optional[dict] = None,
                  ref: str = DEFAULT_REFERENCE) -> dict:
    """The numbers of a train record against the reference `ref`: `prog`,
    the set-up's three steps; `window`, the window's recorded step
    {"before", "item", "record", "after"} (None: the three steps alone).
    `detail`, when given, gets each network's worst leaves and further
    readings that are not compared."""
    with full_f32():
        refs = reference_train(cfg, weights, feed, follow=prog, ref=ref)
        pairs = list(zip(prog, refs))
        if window is not None:
            ref_w = reference_window(cfg, weights, window, ref)
            pairs.append((window["record"], ref_w))
    fresh = [pairs[0]] + pairs[3:]          # the steps from equal policies
    n = {k: 0.0 for k in TRAIN_NUMBERS}
    for p, r in fresh:
        n["logp_gap"] = max(n["logp_gap"], _gap(p["logp"], r["logp"]))
        pl, rfl = p["epoch_losses"], r["epoch_losses"]
        n["actor_loss_gap"] = max(n["actor_loss_gap"], abs(pl["actor"][0] - rfl["actor"][0]))
        n["critic_loss_gap"] = max(n["critic_loss_gap"],
                                   abs(pl["critic"][0] - rfl["critic"][0]) / abs(rfl["critic"][0]))
    for p, r in pairs[1:3]:
        n["logp_later"] = max(n["logp_later"], _gap(p["logp"], r["logp"]))
    for p, r in pairs:
        n["frame_gap"] = max(n["frame_gap"], _gap(p["recon"], r["recon"]))
        scale = abs(r["metrics"]["lpips_loss"])
        for k in ("lpips_loss", "mean_reward"):
            n["reward_gap"] = max(n["reward_gap"],
                                  abs(p["metrics"][k] - r["metrics"][k]) / scale)
        pt, rt = p["targets"], r["targets"]
        n["target_gap"] = max(n["target_gap"], 1.0 if pt.shape != rt.shape else
                              _gap(pt, rt) / rt.abs().max().item())
    for name in policies(ref):
        rm = _norms(refs[0]["moments"][name])
        med = _median(rm.values())
        keep = [k for k, v in rm.items() if v >= SMALL_LEAF * med]
        update = _update_gap(weights[name], prog[-1]["params"][name],
                             refs[-1]["params"][name], keep)
        n["update_gap"] = max(n["update_gap"], _median(update.values()))
        if window is not None:
            w0 = window["before"][name]["params"]
            upd_w = _update_gap(w0, window["after"][name], ref_w["params"][name], keep)
            n["update_gap"] = max(n["update_gap"], _median(upd_w.values()))
        if detail is not None:
            if "moments" in prog[0]:
                moment = _leaf_gaps(_norms(prog[0]["moments"][name]), rm, keep)
                detail[f"{name}.moment"] = [max(moment, key=moment.get), max(moment.values())]
            detail[f"{name}.update"] = [max(update, key=update.get), max(update.values())]
            detail[f"{name}.left_out"] = sorted(set(rm) - set(keep))
    extra = getattr(reference(ref), "extra_numbers", None)
    if extra is not None:
        n.update(extra(pairs))
    if detail is not None:
        detail["last_epoch_losses"] = {k: [prog[0]["metrics"][k], refs[0]["metrics"][k]]
                                       for k in ("actor_loss", "critic_loss")}
        detail["epoch_losses"] = {"program": [p["epoch_losses"] for p, _ in fresh],
                                  "reference": [r["epoch_losses"] for _, r in fresh]}
    return n


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b|, in b's type and on b's device."""
    return (a.to(b).float() - b).abs().max().item()


def _median(values) -> float:
    v = sorted(values)
    return v[len(v) // 2]


def reference_serve(cfg: dict, weights: dict, u8, precision: str = "f32",
                    ref: str = DEFAULT_REFERENCE) -> dict:
    """The reference serving one batch as a program would: greedy pairs and
    uint8 frames."""
    r = reference(ref).Ref(cfg, weights, precision).rollout(_clip(u8))
    return {"frames": _to_u8(r["recon"]), "pairs": r["actions"]}


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    return (x * 255.0 + 0.5).clamp(0.0, 255.0).to(torch.uint8)


def compare_serve(cfg: dict, weights: dict, batches: List[dict],
                  ref: str = DEFAULT_REFERENCE) -> dict:
    """The numbers of served batches {"input", "frames", "pairs"} (uint8
    input, uint8 frames, pairs (T, B, 2)) against the reference `ref`."""
    n = {k: 0.0 for k in SERVE_NUMBERS}
    model = reference(ref).Ref(cfg, weights)
    with full_f32():
        for b in batches:
            r = model.rollout(_clip(b["input"]), actions=b["pairs"])
            n["choice_gap"] = max(n["choice_gap"], r["choice_gap"].max().item())
            n["choice_mean"] += r["choice_gap"].mean().item() / len(batches)
            diff = _to_u8(r["recon"]).int() - b["frames"].to(r["recon"].device).int()
            n["frame_lsb"] = max(n["frame_lsb"], float(diff.abs().max().item()))
    return n


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)
