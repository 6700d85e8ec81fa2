"""The port's LM serving slice against the reference, on the CPU.

Same weights on both sides: the reference's smoke smollm-135m is
initialised with ``jax.random`` and its params carried into the port by
``repro_torch.models.weights``. The reference runs with
``RunConfig(attn_impl="pallas")`` (the Pallas kernel in interpret mode),
f32 weights and bf16 caches; the port runs its plain B4 on the CPU.

Tolerances, with their reasons:

* prefill logits 1e-4: two f32 layers of the smoke model, every sum in
  another order, on logits of order 1;
* caches equal: the same f32 keys and values rounded to bf16 once;
* decode logits 1e-3: the decode path multiplies bf16 operands widened to
  f32 (exact) and sums them in f32 in another order than XLA;
* greedy tokens equal wherever the reference's top-2 margin exceeds twice
  the logit tolerance; past a position where it does not, the two
  contexts may differ and nothing more is compared for that request.

Prompt lengths are few and distinct: each new length recompiles the
interpreted Pallas kernel.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke as ref_get_smoke
from repro.models import RunConfig
from repro.models import build_model as ref_build_model
from repro.models.sharding import ShardingPlan
from repro.serve.batching import ContinuousBatcher as RefBatcher
from repro.serve.batching import Request as RefRequest
from repro_torch.configs import get_config, get_smoke
from repro_torch.models import build_model
from repro_torch.models.weights import from_reference_params, stacked_shapes
from repro_torch.serve.batching import ContinuousBatcher, Request
from repro_torch.serve.engine import ClusterEngine, EngineStats

PREFILL_TOL = 1e-4
DECODE_TOL = 1e-3


@pytest.fixture(scope="module")
def pair():
    jcfg = ref_get_smoke("smollm-135m")
    jmodel = ref_build_model(jcfg, plan=ShardingPlan.null(),
                             rc=RunConfig(attn_impl="pallas"),
                             param_dtype=jnp.float32)
    params, _ = jmodel.init(jax.random.PRNGKey(0))
    model = from_reference_params(get_smoke("smollm-135m"),
                                  jax.tree.map(np.asarray, params),
                                  device="cpu")
    return jmodel, params, model


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=0, atol=tol)


def test_forward_prefill_and_teacher_forced_decode_match_reference(pair):
    jmodel, params, model = pair
    rng = np.random.default_rng(0)
    prompt = rng.integers(2, 512, (2, 11)).astype(np.int32)
    forced = rng.integers(2, 512, (3, 2)).astype(np.int32)
    want, jcaches = jmodel.prefill(params, {"tokens": jnp.asarray(prompt)},
                                   cache_len=16)
    got, caches = model.prefill(torch.from_numpy(prompt).long(),
                                cache_len=16)
    assert got.dtype == torch.float32 and got.shape == (2, 512)
    _close(got.numpy(), want, PREFILL_TOL)
    _close(model(torch.from_numpy(prompt).long()).numpy(),
           jmodel.forward(params, {"tokens": jnp.asarray(prompt)}),
           PREFILL_TOL)
    for name in ("k", "v"):
        assert caches[name].dtype == torch.bfloat16
        assert caches[name].shape == tuple(jcaches[name].shape)
        np.testing.assert_array_equal(
            caches[name].float().numpy(),
            np.asarray(jcaches[name].astype(jnp.float32)))
    for step, tok in enumerate(forced):
        pos = 11 + step
        want, jcaches = jmodel.decode_step(params, jnp.asarray(tok), jcaches,
                                           jnp.int32(pos))
        got, caches = model.decode_step(torch.from_numpy(tok).long(), caches,
                                        pos)
        _close(got.numpy(), want, DECODE_TOL)
    for name in ("k", "v"):
        np.testing.assert_array_equal(
            caches[name].float().numpy(),
            np.asarray(jcaches[name].astype(jnp.float32)))


class _RefRecorder:
    """The reference model behind its batcher, recording each request's
    logits in order (requests told apart by prompt, then by cache)."""

    def __init__(self, model, uid_of_prompt):
        self.model, self.cfg = model, model.cfg
        self.uid_of_prompt = uid_of_prompt
        self.owner = {}
        self.logits = collections.defaultdict(list)

    def _note(self, uid, logits, caches):
        self.logits[uid].append(np.asarray(logits[0], np.float32))
        self.owner[id(caches)] = uid

    def prefill(self, params, batch, cache_len):
        logits, caches = self.model.prefill(params, batch,
                                            cache_len=cache_len)
        uid = self.uid_of_prompt[np.asarray(batch["tokens"])[0].tobytes()]
        self._note(uid, logits, caches)
        return logits, caches

    def decode_step(self, params, tok, caches, pos):
        uid = self.owner.pop(id(caches))
        logits, caches = self.model.decode_step(params, tok, caches, pos)
        self._note(uid, logits, caches)
        return logits, caches


class _PortRecorder(_RefRecorder):
    def __init__(self, model, uid_of_prompt):
        super().__init__(model, uid_of_prompt)
        self.device = model.device

    def prefill(self, tokens, cache_len):
        logits, caches = self.model.prefill(tokens, cache_len=cache_len)
        self._note(self.uid_of_prompt[tokens[0].int().numpy().tobytes()],
                   logits.numpy(), caches)
        return logits, caches

    def decode_step(self, tok, caches, pos):
        uid = self.owner.pop(id(caches))
        logits, caches = self.model.decode_step(tok, caches, pos)
        self._note(uid, logits.numpy(), caches)
        return logits, caches


def test_continuous_batcher_serves_like_reference(pair):
    """Four requests through two slots on both sides: same schedule, same
    tokens where the margin allows, logits within tolerance."""
    jmodel, params, model = pair
    rng = np.random.default_rng(1)
    specs = [(int(n), int(m)) for n, m in ((5, 4), (9, 3), (14, 5), (9, 2))]
    prompts = [rng.integers(2, 512, n).astype(np.int32) for n, _ in specs]
    uid_of = {p.tobytes(): i for i, p in enumerate(prompts)}
    ref_side = _RefRecorder(jmodel, uid_of)
    port_side = _PortRecorder(model, uid_of)
    ref_b = RefBatcher(ref_side, params, max_slots=2, cache_len=24)
    port_b = ContinuousBatcher(port_side, max_slots=2, cache_len=24)
    ref_reqs = [RefRequest(uid=i, prompt=p, max_new_tokens=m)
                for i, (p, (_, m)) in enumerate(zip(prompts, specs))]
    port_reqs = [Request(uid=i, prompt=p, max_new_tokens=m)
                 for i, (p, (_, m)) in enumerate(zip(prompts, specs))]
    for r in ref_reqs:
        ref_b.admit(r)
    for r in port_reqs:
        port_b.admit(r)
    ref_done = sorted(r.uid for r in ref_b.run())
    port_done = sorted(r.uid for r in port_b.run())
    assert port_done == ref_done == [0, 1, 2, 3]

    diverged = False
    for rr, pr in zip(ref_reqs, port_reqs):
        assert pr.done and rr.done
        for t, (want, got) in enumerate(zip(ref_side.logits[rr.uid],
                                            port_side.logits[pr.uid])):
            np.testing.assert_allclose(got, want, rtol=0, atol=DECODE_TOL)
            top2 = np.sort(want[:512])[-2:]
            if top2[1] - top2[0] <= 2 * DECODE_TOL:
                diverged = True
                break
            assert pr.out_tokens[t] == rr.out_tokens[t]
        else:
            assert pr.out_tokens == rr.out_tokens
    if not diverged:
        for key in ("submitted", "retired", "prefills", "decode_steps",
                    "emitted_tokens", "wasted_slot_steps"):
            assert getattr(port_b.stats, key) == getattr(ref_b.stats, key)


@pytest.mark.parametrize("variant", ["full", "smoke_untied_qk_norm"])
def test_model_on_meta_matches_reference_shapes(variant):
    """smollm-135m at full width (and the smoke config with an untied head
    and qk-norm), allocated nowhere: every reference leaf has the port's
    shape, and the count is the reference's analytic one plus the final
    norm, which ``param_count`` leaves out."""
    if variant == "full":
        cfg = get_config("smollm-135m")
        ref_cfg = ref_get_config("smollm-135m")
    else:
        change = {"tie_embeddings": False, "qk_norm": True}
        cfg = dataclasses.replace(get_smoke("smollm-135m"), **change)
        ref_cfg = dataclasses.replace(ref_get_smoke("smollm-135m"), **change)
    model = build_model(cfg, device="meta")
    assert all(p.device.type == "meta" for p in model.parameters())
    n = sum(p.numel() for p in model.parameters())
    assert cfg.param_count() == ref_cfg.param_count()
    assert n == ref_cfg.param_count() + cfg.d_model
    vals, _ = ref_build_model(ref_cfg, param_dtype=jnp.float32
                              ).abstract_params()
    leaves = jax.tree_util.tree_flatten_with_path(vals)[0]
    ref_shapes = {tuple(k.key for k in path): tuple(leaf.shape)
                  for path, leaf in leaves}
    assert stacked_shapes(model) == ref_shapes
    assert n == sum(int(np.prod(s)) for s in ref_shapes.values())


def test_configs_match_reference_and_refuse_unported():
    for getter, ref_getter in ((get_config, ref_get_config),
                               (get_smoke, ref_get_smoke)):
        port, ref = getter("smollm-135m"), ref_getter("smollm-135m")
        for field in port.__dataclass_fields__:
            assert getattr(port, field) == getattr(ref, field), field
        assert port.padded_vocab == ref.padded_vocab
        assert port.param_count() == ref.param_count()
    with pytest.raises(NotImplementedError, match="A18"):
        get_config("olmoe-1b-7b")
    with pytest.raises(KeyError):
        get_config("no-such-arch")


# ---------------------------------------------------------------------------
# Batcher rules with fake models (tests/test_engine.py's, for the port).
# ---------------------------------------------------------------------------


class _ConstLogitModel:
    """Fake decode model: prefill/decode always argmax to a fixed token."""

    class cfg:
        vocab_size = 4

    device = torch.device("cpu")

    def __init__(self, token, fail_on_decode=False):
        self.token = token
        self.fail_on_decode = fail_on_decode

    def _logits(self):
        logits = torch.zeros((1, 4))
        logits[0, self.token] = 5.0
        return logits

    def prefill(self, tokens, cache_len):
        return self._logits(), {}

    def decode_step(self, tok, caches, pos):
        assert not self.fail_on_decode, \
            "decode ran for a request already finished at prefill"
        return self._logits(), caches


def test_token_path_satisfies_engine_protocol():
    token = ContinuousBatcher(model=None, max_slots=1)
    assert isinstance(token, ClusterEngine)
    assert token.flush() == [] and token.retire() == []
    assert token.pending() == 0
    assert isinstance(token.stats, EngineStats)


def test_token_path_retires_at_prefill():
    """EOS (or max_new_tokens) hit by the prefill token retires the request
    before any decode tick — no garbage token past the stop condition."""
    eos_model = _ConstLogitModel(token=1, fail_on_decode=True)
    b = ContinuousBatcher(eos_model, max_slots=2, eos_token=1)
    done = b.admit(Request(uid=0, prompt=np.array([2, 3], np.int32),
                           max_new_tokens=5))
    assert [r.uid for r in done] == [0]
    assert done[0].out_tokens == [1]
    assert b.pending() == 0

    one_model = _ConstLogitModel(token=2, fail_on_decode=True)
    b2 = ContinuousBatcher(one_model, max_slots=1, eos_token=1)
    done = b2.admit(Request(uid=1, prompt=np.array([3], np.int32),
                            max_new_tokens=1))
    assert len(done) == 1 and done[0].out_tokens == [2]
    assert b2.flush() == []


def test_token_path_fills_freed_slots_and_counts_waste():
    """Three requests, two slots: the third waits for a slot, every request
    gets its max_new_tokens, and idle slot-steps are counted."""
    model = _ConstLogitModel(token=2)
    b = ContinuousBatcher(model, max_slots=2, cache_len=64, eos_token=1)
    reqs = [Request(uid=i, prompt=np.array([3, 4], np.int32),
                    max_new_tokens=m) for i, m in enumerate((2, 5, 2))]
    for r in reqs:
        assert b.admit(r) == []
    assert b.pending() == 3 and len(b.queue) == 1
    done = b.flush()
    assert sorted(r.uid for r in done) == [0, 1, 2]
    assert [len(r.out_tokens) for r in reqs] == [2, 5, 2]
    st = b.stats
    assert (st.submitted, st.retired, st.prefills) == (3, 3, 3)
    assert st.emitted_tokens == 9
    assert st.decode_steps == 4 and st.wasted_slot_steps == 2
