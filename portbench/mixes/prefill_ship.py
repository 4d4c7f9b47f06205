"""Traffic ``prefill_ship``: a prefill worker of a disaggregated pool, fed
from a queue that is never empty, whose every request's KV cache crosses
the lossy transport Hadamard-coded.

Parameters (a cell file's ``params``): ``lengths``, prompt lengths
log-uniform from ``min`` to ``max``: a pool of ``pool`` lengths at the
distribution's quantiles (i + 1/2) / pool, each rounded to a multiple of
``round``, or of ``round_tiled`` above ``tiled_above`` tokens; every
seed serves the same pool, each pass over it in an order drawn from
(seed, pass).  With ``strata`` k the pool, sorted, is cut into k equal
strata, and a pass runs in rounds that each take one length of every
stratum: any stretch of a pass then holds nearly the pool's mix, so
that where a window's end cuts a pass changes its rate little from
seed to seed.  Token ids uniform over the vocabulary, ``batch`` 1, one
request outstanding (closed loop: a request is due when the one before
it finished).  Every K and V leaf ships through the coded wire of
``n_rot`` rows, each row arriving with probability ``kv_frac``; the
masks and signs are drawn a request from the seed.  The check takes
every request of the window of at most ``check_up_to`` tokens, and
``sample``, a share of the others drawn from the seed, with the first
request and the first of the longest; the sample's shipped caches are
kept and compared too.  A traced run profiles the next whole pass over
the pool after its window.

The program: ``repro_torch.serve.serve_step.make_prefill(cfg, L)`` on
the request's prompt, the first token the argmax of its last-position
logits, then ``serve_step.degrade_caches(caches, mask, signs=...)``; a
request is done when its token and its shipped caches are on the
device.  The reference (``reference/dense.prefill`` and ``.ship``)
works out the same from the prompt, the weights, the mask and the
signs in float32; compared: the gap by which the served token's logit
lies below the reference's best and the last-position logits, widest
over the requests checked, and the shipped K and V, widest over the
sample.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.harness import cost, weights
from portbench.mixes.train_step import port_config, sync

SPANS = [
    ("repro_torch.models.layers", "attention", "attention", "call"),
    ("repro_torch.serve.serve_step", "degrade_caches", "kv_ship", "call"),
]
MAX_REQUESTS = 4096


def pool(lp: Dict) -> List[int]:
    lo, hi = lp["min"], lp["max"]
    out = []
    for i in range(lp["pool"]):
        x = lo * (hi / lo) ** ((i + 0.5) / lp["pool"])
        r = lp["round_tiled"] if x > lp["tiled_above"] else lp["round"]
        out.append(int(min(hi, max(lo, r * round(x / r)))))
    return out


def lengths(seed: int, lp: Dict, n: int) -> List[int]:
    base = sorted(pool(lp))
    k = lp["strata"]
    if len(base) % k:
        raise ValueError(f"a pool of {len(base)} does not cut into "
                         f"{k} strata")
    w = len(base) // k
    out: List[int] = []
    for c in range(-(-n // len(base))):
        g = weights.rng(seed, weights.LENGTHS, c)
        strata = [[base[s * w + j] for j in g.permutation(w)]
                  for s in range(k)]
        for r in range(w):
            out += [strata[s][r] for s in g.permutation(k)]
    return out[:n]


def setup(ctx, fault: Optional[str] = None) -> None:
    from repro_torch.models import convert
    from repro_torch.serve import serve_step
    p, m = ctx.p, ctx.m
    cfg = port_config(ctx.cell.conf["arch"], m)
    ctx.ref = ctx.cell.reference()
    ctx.specs = ctx.ref.leaf_specs(m)
    if [s["name"] for s in ctx.specs] != list(convert.leaf_names(cfg)):
        raise ValueError("the reference's leaves differ from the port's "
                         "leaf view")
    leaves = weights.make(ctx.specs, ctx.seed, ctx.device)
    ctx.params = convert.params_from_leaves(leaves, cfg)
    ctx.mark("weights")
    ctx.cfg = cfg
    n = p.get("max_requests", MAX_REQUESTS)
    ctx.lengths = lengths(ctx.seed, p["lengths"], n + 1)
    hi = p["lengths"]["max"]
    g = weights.generator(ctx.device, ctx.seed, weights.KV)
    ctx.prompts = torch.randint(0, m["vocab_size"], (n + 1, hi), generator=g,
                                device=ctx.device)
    ctx.masks = torch.rand((n + 1, p["n_rot"]), generator=g,
                           device=ctx.device) < p["kv_frac"]
    ctx.signs = torch.randint(0, 2, (n + 1, p["n_rot"]), generator=g,
                              device=ctx.device).to(torch.float32) * 2 - 1
    u = weights.rng(ctx.seed, weights.SAMPLE).random(n + 1)
    ctx.sampled = set(np.nonzero(u < p["sample"])[0].tolist())
    ctx.sampled |= {0, ctx.lengths.index(max(ctx.lengths))}
    ctx.check_up_to = p["check_up_to"]
    ctx.serve = serve_step
    # looked up at each call, so that a traced run's span wraps it
    ctx.degrade = lambda *a, **k: serve_step.degrade_caches(*a, **k)
    plant(ctx, fault)
    # warm every prompt length the pool holds, on the spare last request
    for length in sorted(set(ctx.lengths)):
        request(ctx, n, length)
        sync(ctx)
        ctx.mark(f"warm {length}")
    ctx.kept = {}


def plant(ctx, fault: Optional[str]) -> None:
    """Faults a test plants in the program, to see ``correct`` fail:
    ``token`` (the served token is the next id), ``unshipped`` (the
    caches skip the wire)."""
    if fault is None:
        return
    if fault == "token":
        ctx.token_shift = 1
    elif fault == "unshipped":
        ctx.degrade = lambda caches, mask, **k: caches
    else:
        raise ValueError(f"no fault {fault!r} in prefill_ship")


def request(ctx, i: int, length: Optional[int] = None):
    """Request i: prefill, first token, KV shipped.  (token, logits,
    shipped caches)."""
    length = length or ctx.lengths[i]
    tokens = ctx.prompts[i:i + 1, :length]
    logits, caches = ctx.serve.make_prefill(ctx.cfg, length)(ctx.params,
                                                             tokens)
    first = torch.argmax(logits, -1)
    if getattr(ctx, "token_shift", 0):
        first = (first + ctx.token_shift) % logits.shape[-1]
    shipped = ctx.degrade(caches, ctx.masks[i], signs=ctx.signs[i])
    return first, logits, shipped


def window(ctx):
    ttft, served = [], 0
    sync(ctx)
    t0 = t_prev = time.perf_counter()
    i = 0
    while True:
        if i >= len(ctx.lengths) - 1:
            raise RuntimeError("the window outran the requests drawn")
        first, logits, shipped = request(ctx, i)
        sync(ctx)
        t = time.perf_counter()
        ttft.append(t - t_prev)
        t_prev = t
        served += ctx.lengths[i]
        if i in ctx.sampled:
            ctx.kept[i] = (first, logits, shipped.leaves())
        elif ctx.lengths[i] <= ctx.check_up_to:
            ctx.kept[i] = (first, logits, None)
        i += 1
        if t - t0 >= ctx.seconds:
            break
    ctx.window_s = t_prev - t0
    ctx.units = i
    ctx.n_done = i
    ctx.flops = sum(cost.prefill_flops(ctx.m, ctx.lengths[j])
                    for j in range(i))
    return ({"ttft_p95_ms": float(np.percentile(ttft, 95)) * 1e3,
             "prefill_tokens_per_s": served / ctx.window_s}, i, 0)


def cache_numels(ctx, length: int) -> List[int]:
    """The K and V leaves' sizes of one prompt: layers x L x kv x hd."""
    m = ctx.m
    n = m["n_layers"] * length * m["n_kv_heads"] * m["head_dim"]
    return [n, n]


def profile_work(ctx) -> None:
    """The next whole pass over the pool: the same lengths in every
    run, so the profile's work is fixed."""
    n = len(pool(ctx.p["lengths"]))
    first = -(-ctx.n_done // n) * n
    for i in range(first, first + n):
        request(ctx, i)
    ctx.prof_units = n
    ctx.prof_fwht_bytes = sum(
        cost.fwht_bytes(cache_numels(ctx, ctx.lengths[i]), ctx.p["n_rot"])
        for i in range(first, first + n))


def release(ctx) -> None:
    ctx.params = None


def reference(ctx, low: bool):
    """The reference's (logits, shipped K, shipped V) of each kept
    request, K and V None where the request's caches were not kept
    (``low``: the control, in float8)."""
    from portbench.reference import dense
    dense.strict_float32()
    P = {s["name"]: t.to(torch.float32) for s, t in
         zip(ctx.specs, weights.make(ctx.specs, ctx.seed, ctx.device))}
    out = {}
    for i in sorted(ctx.kept):
        tokens = ctx.prompts[i:i + 1, :ctx.lengths[i]]
        logits, kv = dense.prefill(P, tokens, ctx.m, ctx.ref.ffn, low)
        if ctx.kept[i][2] is None:
            out[i] = (logits, None, None)
            continue
        k = torch.stack([a for a, _ in kv])       # (layers, 1, L, kv, hd)
        v = torch.stack([b for _, b in kv])
        del kv
        mask, signs = ctx.masks[i], ctx.signs[i]
        out[i] = (logits, dense.ship(k, mask, signs),
                  dense.ship(v, mask, signs))
    del P
    return out


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.to(torch.float32), b.to(torch.float32)
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def gaps(served: Dict, ref: Dict) -> Dict[str, float]:
    """Widest over the kept requests: the served token's logit below the
    reference's best and the logits' relative error; over those whose
    caches were kept, the shipped K/V's relative error."""
    token = logit = kv = 0.0
    for i, (tok, logits, leaves) in served.items():
        r_logits, r_k, r_v = ref[i]
        token = max(token, float(r_logits.max() - r_logits[int(tok)]))
        logit = max(logit, rel(logits.reshape(-1), r_logits))
        if leaves is None:
            continue
        for got, want in zip(leaves, (r_k, r_v)):
            kv = max(kv, rel(got.reshape(want.shape), want))
    return {"token_gap": token, "logit_err": logit, "kv_err": kv}


def check(ctx, control: bool = False) -> Dict[str, float]:
    ref = reference(ctx, low=False)
    out = gaps(ctx.kept, ref)
    if control:
        low = reference(ctx, low=True)
        as_served = {i: (torch.argmax(l), l, None if k is None else [k, v])
                     for i, (l, k, v) in low.items()}
        ctx.control = gaps(as_served, ref)
    ctx.n_checked = len(ctx.kept)
    ctx.n_kv_checked = sum(v[2] is not None for v in ctx.kept.values())
    return out
