"""The driver of ``kind: prefill`` mixes: a prefill machine's queue.

Set-up makes the weights from the seed, gives them to the program's model,
builds ``ContinuousBatcher`` over it and warms it up with one prompt of
each length the mix sends, longest first. The window then drives
``ContinuousBatcher.admit`` → ``Model.prefill`` with requests sent at the
mix's ``rate`` (:func:`traffic.open_loop`) or, where the mix names
``clients``, by that many users who each send again when answered
(:func:`traffic.closed_loop`), each ending at its first token, the
batcher's ``cache_len`` set to the prompt's rounded length before it is
admitted. The model is
reached through :class:`Tap`, which times the start of each prefill and
hands its logits and caches to the sample kept for the check.

After the window the program's state is freed and the reference
(``reference.decoder.prefill``) runs over each kept prompt: the sample
drawn from the seed and the longest prompt served. Two numbers are
compared, each the worst over the sample:

* ``logit_err``: for each prompt, the larger of any logit's distance from
  the reference's and of the served token's logit below the reference's
  best, over the real vocabulary, in units of the reference logits' root
  mean square; the worst over the prompts;
* ``kv_err``: for each row of every layer's key and value cache (a
  token's heads), its distance from the reference's keys or values
  rounded to the cache's dtype, over the reference row's norm (past the
  prompt, where the cache holds zeros, over the median row's); the worst
  over every row of every prompt;
* ``kv_err_p999``: the same rows' 99.9th percentile, over every row of
  every prompt together.

Top-k routing is not continuous: where a token's k-th and next router
logits lie within round-off, two sound float32 programs can choose
different experts, and that token's rows differ from the next layer on.
So a mixture of experts leaves out what the reference itself marks
(``decoder.near_ties``): the rows of a marked token from the layer after
the mark, and a prompt's logits where its last token is marked. A dense
model leaves out nothing. A swap also moves, through attention, the
tokens after the swapped one a little, and rarely one of them crosses a
near-tie wider than the mark's margin: a few rows, each some 1e-2 off.
So a mixture of experts is judged by ``kv_err_p999``, which a fault
that reaches more than a thousandth of the rows still moves, and a dense
model by ``kv_err``.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from reference import decoder
from . import traffic
from .model import as_dtype, make_weights, port_model, spec_of
from .outcome import Outcome, percentile

clock = time.perf_counter


class Tap:
    """The program's model as the batcher sees it, with each prefill's
    start time and outputs recorded on the way through."""

    def __init__(self, model, tracer, fault=None):
        self._model, self._tracer, self._fault = model, tracer, fault
        self.sent = None
        self.last = None

    def __getattr__(self, name):
        return getattr(self._model, name)

    def prefill(self, tokens, **kw):
        if self.sent is not None:
            self.sent.t_start = clock()
        if self._fault == "half_batch":
            tokens = tokens[:, tokens.shape[1] // 2:]
        with self._tracer.span("pb.prefill"):
            logits, caches = self._model.prefill(tokens, **kw)
        if self._fault == "unchanged":
            caches = {n: torch.zeros_like(c) for n, c in caches.items()}
        self.last = (logits, caches)
        return logits, caches


class Sample:
    """The requests kept for the check: the ``k`` of highest priority, a
    number drawn from the seed for each request, and the longest."""

    def __init__(self, seed: int, k: int):
        self.seed, self.k = seed, k
        self.drawn = {}
        self.longest = None

    def offer(self, s, outputs) -> None:
        if outputs is None or s.error is not None:
            return
        item = (s, outputs[0], outputs[1])
        if self.longest is None or s.length > self.longest[0].length:
            self.longest = item
        prio = np.random.default_rng([self.seed, 4, s.uid]).random()
        self.drawn[s.uid] = (prio, item)
        if len(self.drawn) > self.k:
            del self.drawn[min(self.drawn, key=lambda u: self.drawn[u][0])]

    def items(self):
        out = {it[0].uid: it for _, it in self.drawn.values()}
        if self.longest is not None:
            out[self.longest[0].uid] = self.longest
        return [out[u] for u in sorted(out)]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(conf: dict, mix: dict, seed: int, seconds: float, tracer, device,
        t_process: float, dtype: torch.dtype = torch.float32,
        fault=None) -> Outcome:
    """One run of the cell; ``dtype`` other than float32 builds the
    program in it (the control), ``fault`` plants one (tests only)."""
    from repro_torch.serve.batching import ContinuousBatcher, Request

    phases = {"driver": clock() - t_process}
    spec = spec_of(conf)
    weights = make_weights(spec, seed, device, conf.get("init"))
    model = port_model(conf, as_dtype(weights, dtype))
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
    closed = "clients" in mix
    lengths = (traffic.PromptLengths(mix, seed) if closed else
               traffic.prompt_lengths(mix, seed,
                                      int(seconds * mix["rate"]) + 16))
    _sync(device)
    phases["warmup"] = clock() - t_process
    tracer.start()
    t0 = clock()
    setup_s = t0 - t_process
    t_trace = t0 + mix["trace_seconds"]

    def send(s: traffic.Sent) -> None:
        serve(s, traffic.prompt_tokens(seed, s.uid, s.length, spec.vocab))

    if closed:
        sends = traffic.closed_loop(send, lengths, mix["clients"], t0,
                                    t0 + seconds, clock)
    else:
        sends = traffic.open_loop(send, lengths, mix["rate"], t0,
                                  t0 + seconds, clock, time.sleep)
    _sync(device)
    tracer.stop()
    in_window = [s for s in sends if not s.late]
    t_close = max(s.t_done for s in in_window)
    answered = [s for s in sends if s.error is None]
    tokens = sum(s.length for s in in_window if s.error is None)
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
                          "backlog_at_close": sum(s.late for s in sends),
                          "setup_phases_s": phases})


def check(spec, weights, kept, seed: int):
    """(``logit_err``, ``kv_err`` and ``kv_err_p999`` (module docstring)
    over ``kept``, a list of (request, logits, caches); notes: the longest prompt's two
    numbers, what was left out, each prompt's readings, and the
    reference's dropped share and near-ties)."""
    if not kept:
        return {"logit_err": float("inf"), "kv_err": float("inf"),
                "kv_err_p999": float("inf")}, {}
    v = spec.vocab
    logit, clean_logit, kv, per_prompt, kept_rows = [], [], [], [], []
    dropped = assigned = rows_left_out = 0
    for s, logits, caches in kept:
        prompt = torch.as_tensor(traffic.prompt_tokens(
            seed, s.uid, s.length, v), device=logits.device)
        ref = decoder.prefill(weights, spec, prompt)
        dropped += ref.dropped
        assigned += s.length * spec.top_k * spec.layers
        lr, lp = ref.logits, logits[0, :v].float()
        gap = lr.max() - lr[s.token]
        err = float(torch.maximum((lp - lr).abs().max(), gap)
                    / torch.sqrt(torch.mean(lr * lr)))
        worst, left_out = 0.0, 0
        for name, want in (("k", ref.keys), ("v", ref.values)):
            for layer, w in enumerate(want):
                got = caches[name][layer, 0].float().flatten(1)
                w = w.flatten(1)
                scale = torch.linalg.vector_norm(w, dim=1)
                full = torch.zeros_like(got)
                full[:len(w)] = w.to(caches[name].dtype).float()
                dist = torch.linalg.vector_norm(got - full, dim=1)
                rows = torch.cat([dist[:len(w)] / scale,
                                  dist[len(w):] / scale.median()])
                keep = torch.ones_like(rows, dtype=torch.bool)
                keep[:len(w)] = ref.tainted_from > layer
                left_out += int((~keep).sum())
                worst = max(worst, float(rows[keep].max()))
                kept_rows.append(rows[keep])
        logit.append(err)
        if not ref.logits_tainted:
            clean_logit.append(err)
        kv.append(worst)
        rows_left_out += left_out
        per_prompt.append([s.uid, s.length, err, worst, ref.near_ties,
                           left_out, ref.logits_tainted])
        del ref
    rows = torch.sort(torch.cat(kept_rows)).values
    checks = {"logit_err": max(clean_logit or logit), "kv_err": max(kv),
              "kv_err_p999": float(rows[math.ceil(0.999 * len(rows)) - 1])}
    longest = max(per_prompt, key=lambda r: r[1])
    notes = {"longest_logit_kv": longest[2:4],
             "kv_rows_left_out": rows_left_out,
             "logits_left_out": len(logit) - len(clean_logit),
             "prompts_uid_len_logit_kv_ties_rowsout_logitout": per_prompt,
             "reference_dropped_share": dropped / assigned if spec.moe
             else 0.0}
    return checks, notes


__all__ = ["run", "check", "Tap", "Sample"]
