"""Traffic ``train_step``: a data-parallel pretraining job's steps on one
chip, through the port's own train step with the coded gradient sync.

Parameters (a cell file's ``params``): ``batch`` rows of ``seq`` tokens a
step, token ids uniform over the vocabulary, every step's rows drawn
anew from (seed, step); ``mode`` the sync (``lossy_hadamard``), its
``drop_rate``, ``n_rot`` and ``min_coded_size``; ``adamw`` the
optimizer's settings; ``checked_steps`` (3) the steps that set-up takes
and the reference follows; ``profile_steps`` the steps a traced run
profiles after the window.  Each step's arrival masks (Bernoulli(1 -
drop_rate) a wire row) and rotation signs, one of each a coded leaf, are
drawn from (seed, step) and handed to the step as ``masks=`` and
``signs=``.

The program: ``repro_torch.train.train_step.make_train_step(cfg,
celeris=CelerisConfig(mode, n_rot, min_coded_size), opt_cfg, donate=True)``
on one device, its state from ``state_from_params`` over the weights
that ``harness/weights.py`` made.  Set-up drives that state through the
checked steps and hands it to the window.  The reference
(``reference/dense.train``) follows the checked steps from the same
weights, batches, masks and signs in float32; compared: each step's
loss, the first gradient as AdamW takes it (``mu / (1 - b1)`` after step
1), and the change of the float32 master after the last checked step,
leaf by leaf.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Dict, Optional

import torch

from portbench.harness import cost, weights

SPANS = [
    ("repro_torch.train.train_step", "accum_grads", "fwd_bwd", "call"),
    ("repro_torch.train.train_step", "_draw", "grad_code", "call"),
    ("repro_torch.train.train_step", "_code_grads", "grad_code", "call"),
    ("repro_torch.optim.adamw", "apply_updates", "adamw", "call"),
    ("repro_torch.models.moe", "moe_block", "moe", "autograd"),
]

# leaves whose reference gradient is under this share of the median
# leaf's move by round-off alone under AdamW: their change is not
# compared (a key bias under softmax)
NOUGHT = 1e-3


def port_config(arch: str, m: Dict):
    """The port's ModelConfig of ``arch`` at the file's depth and head
    padding, checked against every size the file states (``preset`` ``smoke``: the port's
    small config of the same family, for the CPU tests)."""
    from repro_torch import configs
    base = (configs.get_smoke(arch) if m.get("preset") == "smoke"
            else configs.get(arch))
    cfg = dataclasses.replace(base, n_layers=m["n_layers"],
                              head_pad_multiple=m["head_pad_multiple"])
    want = {"d_model": m["d_model"], "n_heads": m["n_heads"],
            "n_kv_heads": m["n_kv_heads"], "d_ff": m["d_ff"],
            "vocab_size": m["vocab_size"], "qkv_bias": m["qkv_bias"],
            "tie_embeddings": m["tie_embeddings"],
            "rope_fraction": m["rope_fraction"],
            "rope_theta": m["rope_theta"], "norm_eps": m["norm_eps"],
            "dtype": m["dtype"],
            "head_pad_multiple": m["head_pad_multiple"],
            "resolved_head_dim": m["head_dim"]}
    if m["moe"]:
        mo = m["moe"]
        want.update({"moe.n_experts": mo["n_experts"],
                     "moe.top_k": mo["top_k"], "moe.d_expert": mo["d_expert"],
                     "moe.n_shared": mo["n_shared"],
                     "moe.capacity_factor": mo["capacity_factor"],
                     "moe.router_z_weight": mo["router_z_weight"],
                     "moe.aux_weight": mo["aux_weight"]})
    for key, value in want.items():
        obj = cfg
        for part in key.split("."):
            obj = getattr(obj, part)
        if obj != value:
            raise ValueError(f"{arch}: the port has {key}={obj!r}, the "
                             f"configuration file {value!r}")
    if (m["moe"] is None) != (cfg.moe is None):
        raise ValueError(f"{arch}: MoE in the port and the file differ")
    return cfg


def coded_leaves(specs, p: Dict):
    """(leaf index, rotation width) of each leaf the sync codes."""
    return [(i, cost.rotation_n(cost.numel(s["shape"]), p["n_rot"]))
            for i, s in enumerate(specs)
            if cost.numel(s["shape"]) >= p["min_coded_size"]]


def draws(seed: int, step: int, coded, drop_rate: float, device):
    """Step ``step``'s arrival masks and signs by leaf index."""
    g = weights.generator(device, seed, weights.SYNC, step)
    width = max(n for _, n in coded)
    u = torch.rand((len(coded), width), generator=g, device=device)
    bits = torch.randint(0, 2, (len(coded), width), generator=g,
                         device=device)
    keep = u >= drop_rate
    sign = bits.to(torch.float32) * 2 - 1
    return ({i: keep[j, :n] for j, (i, n) in enumerate(coded)},
            {i: sign[j, :n] for j, (i, n) in enumerate(coded)})


def batch(ctx, step: int) -> Dict[str, torch.Tensor]:
    t = weights.tokens(ctx.seed, step, ctx.p["batch"], ctx.p["seq"],
                       ctx.m["vocab_size"], ctx.device)
    return {"tokens": t, "labels": t}


def setup(ctx, fault: Optional[str] = None) -> None:
    from repro_torch.models import convert
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as ts
    p, m = ctx.p, ctx.m
    cfg = port_config(ctx.cell.conf["arch"], m)
    ctx.ref = ctx.cell.reference()
    ctx.specs = ctx.ref.leaf_specs(m)
    names = [s["name"] for s in ctx.specs]
    shapes = [tuple(s["shape"]) for s in ctx.specs]
    if (names != list(convert.leaf_names(cfg))
            or shapes != [tuple(s) for s in convert.leaf_shapes(cfg)]):
        raise ValueError("the reference's leaves differ from the port's "
                         "leaf view")
    leaves = weights.make(ctx.specs, ctx.seed, ctx.device)
    ctx.mark("weights")
    ctx.coded = coded_leaves(ctx.specs, p)
    celeris = ts.CelerisConfig(mode=p["mode"], n_rot=p["n_rot"],
                               min_coded_size=p["min_coded_size"])
    ctx.step = ts.make_train_step(cfg, celeris=celeris,
                                  opt_cfg=adamw.OptConfig(**p["adamw"]),
                                  donate=True)
    ctx.state = ts.state_from_params(leaves, cfg)
    ctx.mark("optimizer state")
    plant(ctx, fault)
    b1 = p["adamw"]["b1"]
    losses = []
    for k in range(p["checked_steps"]):
        run_step(ctx, k)
        losses.append(ctx.metrics["loss"])
        ctx.mark(f"step {k + 1}")
        if k == 0:
            first = torch.stack([mu.norm() for mu in ctx.state["opt"]["mu"]]
                                ) / (1 - b1)
    change = torch.stack([(w - w0.to(torch.float32)).norm() for w, w0 in
                          zip(ctx.state["opt"]["master"], leaves)])
    del leaves
    ctx.got = {"losses": [float(x) for x in losses],
               "first_grad": first.tolist(), "change": change.tolist()}
    ctx.next_step = p["checked_steps"]


def plant(ctx, fault: Optional[str]) -> None:
    """Faults a test plants in the program, to see ``correct`` fail:
    ``state_unchanged`` (the step hands back the state it got),
    ``half_batch`` (the step sees the first half of its rows)."""
    if fault is None:
        return
    step = ctx.step
    if fault == "state_unchanged":
        def frozen(state, batch, *a, **k):
            _, met = step({"params": [t.clone() for t in state["params"]],
                           "opt": {n: ([t.clone() for t in v]
                                       if isinstance(v, list) else v.clone())
                                   for n, v in state["opt"].items()},
                           "step": state["step"]}, batch, *a, **k)
            return state, met
        ctx.step = frozen
    elif fault == "half_batch":
        def half(state, batch, *a, **k):
            rows = batch["tokens"].shape[0] // 2
            return step(state, {n: v[:rows] for n, v in batch.items()},
                        *a, **k)
        ctx.step = half
    else:
        raise ValueError(f"no fault {fault!r} in train_step")


def sync(ctx) -> None:
    if ctx.device != "cpu":
        torch.cuda.synchronize()


def run_step(ctx, k: int) -> None:
    masks, signs = draws(ctx.seed, k, ctx.coded, ctx.p["drop_rate"],
                         ctx.device)
    ctx.state, ctx.metrics = ctx.step(ctx.state, batch(ctx, k), None,
                                      ctx.p["drop_rate"], masks=masks,
                                      signs=signs)


def window(ctx):
    """Steps until ``seconds`` have passed, each ending in a
    synchronize; the rate is every step's tokens over the whole time."""
    p = ctx.p
    losses = []
    sync(ctx)
    t0 = time.perf_counter()
    n = 0
    while True:
        run_step(ctx, ctx.next_step)
        sync(ctx)
        losses.append(ctx.metrics["loss"])
        ctx.next_step += 1
        n += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    ctx.window_s = time.perf_counter() - t0
    ctx.units = n
    tokens = n * p["batch"] * p["seq"]
    ctx.flops = n * cost.train_step_flops(ctx.m, p["batch"], p["seq"])
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    return {"train_tokens_per_s": tokens / ctx.window_s}, n, failed


def profile_work(ctx) -> None:
    for _ in range(ctx.p["profile_steps"]):
        run_step(ctx, ctx.next_step)
        ctx.next_step += 1
    ctx.prof_units = ctx.p["profile_steps"]
    ctx.prof_fwht_bytes = ctx.prof_units * cost.fwht_bytes(
        [cost.numel(ctx.specs[i]["shape"]) for i, _ in ctx.coded],
        ctx.p["n_rot"])


def release(ctx) -> None:
    ctx.state = ctx.step = ctx.metrics = None


def reference(ctx, low: bool) -> Dict:
    """The reference's readings over the checked steps (``low``: the
    control, in float8)."""
    from portbench.reference import dense
    dense.strict_float32()
    leaves = weights.make(ctx.specs, ctx.seed, ctx.device)
    # copies, even of a float32 leaf: the reference updates P in place
    # and measures the change against ``leaves``
    P = {s["name"]: t.to(torch.float32, copy=True)
         for s, t in zip(ctx.specs, leaves)}
    k = ctx.p["checked_steps"]
    batches = [batch(ctx, i) for i in range(k)]
    dr = [draws(ctx.seed, i, ctx.coded, ctx.p["drop_rate"], ctx.device)
          for i in range(k)]
    out = dense.train(P, [s["name"] for s in ctx.specs], batches, dr,
                      ctx.m, ctx.ref.ffn, ctx.p["adamw"], low, W0=leaves)
    del P, leaves
    return out


def gaps(got: Dict, ref: Dict) -> Dict[str, float]:
    """The compared numbers: the widest loss gap over the checked steps,
    and for the first gradient and the change the worst leaf's gap of
    norms over the larger of its reference norm and the median leaf's."""
    loss = max(abs(a - b) for a, b in zip(got["losses"], ref["losses"]))
    g_med = statistics.median(ref["first_grad"])
    c_med = statistics.median(ref["change"])
    grad = max(abs(a - b) / max(b, g_med)
               for a, b in zip(got["first_grad"], ref["first_grad"]))
    counted = [i for i, g in enumerate(ref["first_grad"])
               if g >= NOUGHT * g_med]
    change = max(abs(got["change"][i] - ref["change"][i])
                 / max(ref["change"][i], c_med) for i in counted)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def leaves_table(ctx, got: Dict, ref: Dict):
    """Per leaf: (name, first gradient's norm program / reference, the
    change's norm program / reference)."""
    return [(s["name"], a, b, c, d) for s, a, b, c, d in zip(
        ctx.specs, got["first_grad"], ref["first_grad"], got["change"],
        ref["change"])]


def check(ctx, control: bool = False) -> Dict[str, float]:
    ref = reference(ctx, low=False)
    ctx.ref_readings = ref
    ctx.detail = {"losses": [ctx.got["losses"], ref["losses"]],
                  "leaves": leaves_table(ctx, ctx.got, ref)}
    out = gaps(ctx.got, ref)
    if control:
        low = reference(ctx, low=True)
        ctx.control = gaps(low, ref)
        ctx.control_detail = {"losses": [low["losses"], ref["losses"]],
                              "leaves": leaves_table(ctx, low, ref)}
    return out
