"""What runs a ``kind: hybrid_prefill`` mix: a prefill machine's queue on a
model whose layers mix Mamba2 mixers and attention, each followed by
experts and a shared expert (granite-4.0-h-small, ``family: hybrid_moe``).

``harness/prefill.py`` and ``harness/model.py`` build the dense and MoE
decoders; this module builds the hybrid from its configuration file and
otherwise serves as ``prefill.py`` does, with its ``Tap``, ``Sample``,
traffic and ``Outcome``. Set-up builds the program's model on the meta
device (a program without the hybrid family fails here, before any
weight is drawn), makes the weights from the seed, hands the same tensors
to the program and to the reference (``reference/granite_hybrid.py``),
builds ``ContinuousBatcher`` over the model and warms it up with one
prompt of each length the mix sends, longest first. The window drives
``ContinuousBatcher.admit`` → ``Model.prefill`` with ``clients`` users in
a closed loop, each request ending at its first token.

The weights are one draw of a truncated normal over every matrix on the
card, scaled by ``1/sqrt(fan_in)``, norm scales and ``D`` at ones, and
Mamba2's published draws for ``A_log`` (A uniform in [1, 16]) and
``dt_bias`` (the inverse softplus of a dt log-uniform in [1e-3, 1e-1]).
The configuration's ``init`` key may set the embedding's scale and scale
the projections that write into the residual again by ``1/sqrt(2 ·
layers)``, as ``harness/model.py`` does.

After the window the program's state is freed and the reference runs
over each kept prompt (the sample drawn from the seed and the longest
prompt served). What a decode machine would receive is compared, each
number the worst over the sample unless said:

* ``logit_err``: as ``prefill.check``: any logit's distance from the
  reference's, or the served token's logit below the reference's best,
  over the reference logits' root mean square; prompts whose last token
  the reference marks at a near-tie are left out;
* ``kv_err`` and ``kv_err_p999``: each attention layer's key and value
  rows as ``prefill.check`` judges them (the worst row, and the 99.9th
  percentile of all rows together), the rows of a token marked at a
  near-tie before that layer left out;
* ``conv_err``: each Mamba2 layer's conv state, the last K − 1 rows of the
  conv's input, each row's distance from the reference's rounded to the
  cache's dtype over the reference row's norm, marked rows left out;
* ``state_err``: each Mamba2 layer's final SSM state, each head's (N, P)
  matrix's distance from the reference's over the reference's norm, the
  worst over every head of every layer of every compared prompt. The
  state sums every token's input, so a routing swap anywhere upstream
  moves it, but by less than a thousandth of the limit: no head is left
  out.

The cell is judged by ``logit_err``, ``kv_err_p999``, ``conv_err`` and
``state_err``; ``kv_err``, the worst row, is kept in the notes.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from reference import granite_hybrid as ref
from . import traffic
from .outcome import Outcome, percentile
from .prefill import Sample, Tap

clock = time.perf_counter

# The projections that write into the residual stream.
RESIDUAL_OUT = ("attn.wo", "mamba.out_proj", "moe.wo", "shared.wo")
# Kept in float32 whatever the program's dtype, as the program keeps them.
F32_LEAVES = ("moe.router", "mamba.A_log", "mamba.D", "mamba.dt_bias")


def spec_of(conf: dict) -> ref.Spec:
    """The reference's sizes from a configuration file's keys."""
    d, heads = conf["hidden_size"], conf["num_attention_heads"]
    run, dep = conf["run"], conf["deployment"]
    rnd, vocab = run["vocab_round"], conf["vocab_size"]
    return ref.Spec(
        layer_types=tuple(conf["layer_types"]), d_model=d, heads=heads,
        kv_heads=conf["num_key_value_heads"],
        head_dim=conf.get("head_dim", d // heads), vocab=vocab,
        padded_vocab=-(-vocab // rnd) * rnd, eps=conf["rms_norm_eps"],
        ssm_heads=conf["mamba_n_heads"], ssm_head_dim=conf["mamba_d_head"],
        ssm_state=conf["mamba_d_state"], conv_k=conf["mamba_d_conv"],
        chunk=conf["mamba_chunk_size"], experts=dep["router_experts"],
        held=conf["num_local_experts"], first=dep["experts_first"],
        top_k=conf["num_experts_per_tok"],
        expert_ff=conf["intermediate_size"],
        shared_ff=conf["shared_intermediate_size"],
        embedding_multiplier=float(conf["embedding_multiplier"]),
        attention_multiplier=float(conf["attention_multiplier"]),
        residual_multiplier=float(conf["residual_multiplier"]),
        logits_scaling=float(conf["logits_scaling"]),
        capacity_factor=run["moe_capacity"],
        token_chunk=run["moe_token_chunk"])


def port_config(conf: dict):
    """The program's configuration of a configuration file: the card's
    share of the deployment (its held experts)."""
    from repro_torch.configs.base import HybridMoEConfig

    s = spec_of(conf)
    return HybridMoEConfig(
        name=conf["name"], family=conf["family"], num_layers=s.layers,
        d_model=s.d_model, num_heads=s.heads, num_kv_heads=s.kv_heads,
        d_ff=s.expert_ff, moe_d_ff=s.expert_ff, vocab_size=s.vocab,
        head_dim=s.head_dim, tie_embeddings=conf["tie_word_embeddings"],
        rope_theta=float(conf["rope_theta"]), norm_eps=s.eps,
        num_experts=s.experts, experts_per_tok=s.top_k,
        shared_expert_d_ff=s.shared_ff, ssm_state=s.ssm_state,
        ssm_head_dim=s.ssm_head_dim,
        ssm_expand=s.d_inner // s.d_model, layer_types=s.layer_types,
        nope=conf["position_embedding_type"] == "nope",
        ssm_conv_xbc=bool(conf["mamba_conv_bias"]),
        embedding_multiplier=s.embedding_multiplier,
        attention_multiplier=s.attention_multiplier,
        residual_multiplier=s.residual_multiplier,
        logits_scaling=s.logits_scaling, experts_held=s.held,
        experts_first=s.first, vocab_round=conf["run"]["vocab_round"])


def run_config(conf: dict):
    """The program's ``RunConfig`` of a configuration file."""
    from repro_torch.models.transformer import RunConfig

    run = conf["run"]
    return RunConfig(moe_impl=run["moe_impl"],
                     moe_capacity=run["moe_capacity"],
                     moe_token_chunk=run["moe_token_chunk"],
                     ssd_chunk=conf["mamba_chunk_size"])


def meta_model(conf: dict):
    """The program's model of ``conf`` on the meta device: its weights'
    names and shapes, nothing allocated."""
    from repro_torch.models import build_model

    return build_model(port_config(conf), device="meta", rc=run_config(conf))


def make_weights(spec: ref.Spec, seed: int, device, init=None) -> dict:
    """Every weight of ``spec`` from ``seed`` (module docstring): views of
    one float32 buffer."""
    init = init or {}
    depth = (1.0 / math.sqrt(2 * spec.layers)
             if init.get("residual_depth_scaled") else 1.0)
    items = ref.leaves(spec)
    total = sum(math.prod(shape) for _, shape, _ in items)
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.empty(total, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(buf, 0.0, 1.0, -2.0, 2.0, generator=gen)
    out, off = {}, 0
    for name, shape, kind in items:
        n = math.prod(shape)
        t = buf[off:off + n].view(shape)
        off += n
        if kind == "ones":
            t.fill_(1.0)
        elif kind == "A_log":
            t.uniform_(1.0, 16.0, generator=gen).log_()
        elif kind == "dt_bias":
            lo, hi = math.log(1e-3), math.log(1e-1)
            dt = torch.rand(shape, generator=gen, device=device) \
                .mul_(hi - lo).add_(lo).exp_()
            t.copy_(dt + torch.log(-torch.expm1(-dt)))
        elif name == "embed" and "embed_std" in init:
            t.mul_(float(init["embed_std"]))
        else:
            scale = depth if name.endswith(RESIDUAL_OUT) else 1.0
            t.mul_(scale / math.sqrt(kind))
        out[name] = t
    return out


def as_dtype(weights: dict, dtype: torch.dtype) -> dict:
    """``weights`` themselves for float32; else copies in ``dtype``, the
    leaves the program keeps in float32 kept so."""
    if dtype == torch.float32:
        return weights
    return {n: t if n.endswith(F32_LEAVES) else t.to(dtype)
            for n, t in weights.items()}


def port_model(model, weights: dict):
    """``model`` (from :func:`meta_model`) holding ``weights`` (no copy).
    Raises where the program's weights differ in name or shape."""
    from repro_torch.models.common import attach_axes

    want = {n: tuple(p.shape) for n, p in model.named_parameters()}
    have = {n: tuple(t.shape) for n, t in weights.items()}
    if want != have:
        diff = sorted(set(want.items()) ^ set(have.items()))[:6]
        raise ValueError(f"the program's weights differ from the "
                         f"benchmark's: {diff}")
    model.load_state_dict(weights, strict=True, assign=True)
    attach_axes(model, model.param_axes)
    return model


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(conf: dict, mix: dict, seed: int, seconds: float, tracer, device,
        t_process: float, dtype: torch.dtype = torch.float32,
        fault=None) -> Outcome:
    """One run of the cell; ``dtype`` other than float32 builds the
    program in it (the control), ``fault`` plants one (tests only)."""
    from repro_torch.serve.batching import ContinuousBatcher, Request

    phases = {"imports": clock() - t_process}
    model = meta_model(conf)
    spec = spec_of(conf)
    weights = make_weights(spec, seed, device, conf.get("init"))
    model = port_model(model, as_dtype(weights, dtype))
    _sync(device)
    phases["weights"] = clock() - t_process
    tap = Tap(model, tracer, fault)
    batcher = ContinuousBatcher(tap, max_slots=mix["max_slots"],
                                cache_len=mix["cache_round"])
    if fault == "answer":
        greedy = batcher._greedy
        batcher._greedy = lambda lg: (greedy(lg) + 1) % spec.vocab
    sample = Sample(seed, mix["check_sample"])
    traced = []

    def serve(s: traffic.Sent, prompt: np.ndarray) -> None:
        req = Request(uid=s.uid, prompt=prompt,
                      max_new_tokens=mix["max_new_tokens"])
        batcher.cache_len = traffic.cache_len(mix, len(prompt))
        tap.sent, tap.last = s, None
        on = tracer.running
        with tracer.span("pb.admit"):
            try:
                done = batcher.admit(req)
            except Exception as e:           # a failed request, counted
                s.error = f"{type(e).__name__}: {e}"
                done = []
        s.t_done = clock()
        if s.error is None:
            if any(r is req for r in done) and req.out_tokens:
                s.token = int(req.out_tokens[0])
            else:
                s.error = "no first token"
        if s.uid >= 0:
            sample.offer(s, tap.last)
        tap.last = None
        if on:
            traced.append(s)
        if tracer.running and s.t_done >= t_trace:
            tracer.stop()

    wrng = np.random.default_rng([seed, 9])
    for i, n in enumerate(traffic.distinct_lengths(mix)):
        s = traffic.Sent(-1 - i, int(n), clock())
        serve(s, wrng.integers(0, spec.vocab, n, dtype=np.int32))
        if s.error:
            raise RuntimeError(f"warm-up prefill of {n} tokens: {s.error}")
    lengths = traffic.PromptLengths(mix, seed)
    _sync(device)
    phases["warmup"] = clock() - t_process
    tracer.start()
    t0 = clock()
    setup_s = t0 - t_process
    t_trace = t0 + mix["trace_seconds"]

    def send(s: traffic.Sent) -> None:
        serve(s, traffic.prompt_tokens(seed, s.uid, s.length, spec.vocab))

    sends = traffic.closed_loop(send, lengths, mix["clients"], t0,
                                t0 + seconds, clock)
    _sync(device)
    tracer.stop()
    t_close = max(s.t_done for s in sends)
    answered = [s for s in sends if s.error is None]
    tokens = sum(s.length for s in answered)
    e2e = {"prefill_tokens_per_s": tokens / (t_close - t0),
           "ttft_p90_ms": percentile(
               [(s.t_done - s.t_send) * 1e3 for s in answered], 90),
           "setup_s": setup_s}
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    failures = [s.error for s in sends if s.error is not None]

    del batcher, tap, model
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    checks, found = check(spec, weights, sample.items(), seed)
    layer = {"kind": "prefill", "spec": spec, "reading": tracer.reading,
             "prompts": [s.length for s in traced if s.error is None],
             "queue_ms": [(s.t_start - s.t_send) * 1e3 for s in traced
                          if s.error is None]}
    return Outcome(e2e=e2e, attempted=len(sends), failed=len(failures),
                   failures=failures[:3], checks=checks, memory_peak=peak,
                   reading=tracer.reading, layer=layer,
                   notes={"compared": len(sample.items()), **found,
                          "setup_phases_s": phases})


def _row_errors(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Each row's distance of the cache rows ``got`` (R, ...) from the
    reference's ``want`` (r ≤ R rows) rounded to the cache's dtype, over
    ``want``'s row norm; rows past ``r`` (zeros where the cache is longer
    than the prompt) over the median row's norm."""
    w = want.float().flatten(1)
    scale = torch.linalg.vector_norm(w, dim=1)
    full = torch.zeros_like(got, dtype=torch.float32).flatten(1)
    full[:len(w)] = w.to(got.dtype).float()
    dist = torch.linalg.vector_norm(got.float().flatten(1) - full, dim=1)
    return torch.cat([dist[:len(w)] / scale, dist[len(w):] / scale.median()])


def check(spec: ref.Spec, weights: dict, kept, seed: int):
    """The numbers of the module docstring over ``kept``, a list of
    (request, logits, caches); notes: the longest prompt's numbers, what
    was left out, each prompt's readings, and the reference's dropped
    share and near-ties."""
    names = ("logit_err", "kv_err", "kv_err_p999", "conv_err", "state_err")
    if not kept:
        return {n: float("inf") for n in names}, {}
    v = spec.vocab
    logit, clean_logit, kv, conv, kv_rows, heads = [], [], [], [], [], []
    per_prompt = []
    dropped = assigned = ties = rows_left_out = 0
    for s, logits, caches in kept:
        prompt = torch.as_tensor(traffic.prompt_tokens(
            seed, s.uid, s.length, v), device=logits.device)
        r = ref.prefill(weights, spec, prompt)
        dropped += r.dropped
        assigned += r.assigned
        ties += r.near_ties
        lr, lp = r.logits, logits[0, :v].float()
        gap = lr.max() - lr[s.token]
        err = float(torch.maximum((lp - lr).abs().max(), gap)
                    / torch.sqrt(torch.mean(lr * lr)))
        worst_kv, worst_conv, left_out = 0.0, 0.0, 0
        for a, layer in enumerate(spec.attention_layers):
            for name, want in (("k", r.keys[a]), ("v", r.values[a])):
                got = caches[name][a, 0]
                rows = _row_errors(got, want)
                keep = torch.ones_like(rows, dtype=torch.bool)
                keep[:len(want)] = r.tainted_from > layer
                left_out += int((~keep).sum())
                worst_kv = max(worst_kv, float(rows[keep].max()))
                kv_rows.append(rows[keep])
        for m, layer in enumerate(spec.mamba_layers):
            got = caches["conv"][m, 0]
            rows = _row_errors(got, r.conv_states[m])
            tail = r.tainted_from[-len(rows):] > layer
            left_out += int((~tail).sum())
            if tail.any():
                worst_conv = max(worst_conv, float(rows[tail].max()))
            st, want = caches["ssm"][m, 0].float(), r.ssm_states[m]
            heads.append(torch.linalg.vector_norm((st - want).flatten(1),
                                                  dim=1)
                         / torch.linalg.vector_norm(want.flatten(1), dim=1))
        logit.append(err)
        if not r.logits_tainted:
            clean_logit.append(err)
        kv.append(worst_kv)
        conv.append(worst_conv)
        rows_left_out += left_out
        per_prompt.append([s.uid, s.length, err, worst_kv, worst_conv,
                           float(torch.cat(heads[-len(spec.mamba_layers):])
                                 .max()) if spec.mamba_layers else 0.0,
                           r.near_ties, left_out, r.logits_tainted])
        del r
    rows = torch.sort(torch.cat(kv_rows)).values
    checks = {"logit_err": max(clean_logit or logit), "kv_err": max(kv),
              "kv_err_p999": float(rows[math.ceil(0.999 * len(rows)) - 1]),
              "conv_err": max(conv),
              "state_err": float(torch.cat(heads).max()) if heads else 0.0}
    longest = max(per_prompt, key=lambda p: p[1])
    notes = {"longest_logit_kv_conv_state": longest[2:6],
             "rows_left_out": rows_left_out,
             "logits_left_out": len(logit) - len(clean_logit),
             "prompts_uid_len_logit_kv_conv_state_ties_rowsout_logitout":
                 per_prompt,
             "reference_dropped_share": dropped / assigned,
             "reference_near_ties": ties}
    return checks, notes


__all__ = ["run", "check", "spec_of", "port_config", "run_config",
           "meta_model", "make_weights", "as_dtype", "port_model"]
