"""The reference against the program at the smoke size on the CPU: prefill
logits and caches with experts dropped at capacity, and the first training
steps."""

import numpy as np
import pytest
import torch

from conftest import smoke_conf, smoke_mix
from harness import model as hm
from harness import prefill, traffic, train
from reference import decoder


@pytest.mark.parametrize("name", ["granite-3-2b", "olmoe-1b-7b"])
def test_prefill_logits_and_caches(name):
    conf = smoke_conf(name)
    spec = hm.spec_of(conf)
    weights = hm.make_weights(spec, 11, "cpu")
    m = hm.port_model(conf, weights)
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, spec.vocab, 200), dtype=torch.long)
    logits, caches = m.prefill(prompt[None], cache_len=256)
    ref = decoder.prefill(weights, spec, prompt)
    torch.testing.assert_close(logits[0, :spec.vocab], ref.logits,
                               rtol=1e-5, atol=1e-5)
    for layer in range(spec.layers):
        for got, want in ((caches["k"][layer, 0], ref.keys[layer]),
                          (caches["v"][layer, 0], ref.values[layer])):
            assert got.dtype == torch.bfloat16
            torch.testing.assert_close(got[:200].float(),
                                       want.to(torch.bfloat16).float(),
                                       rtol=0, atol=0)
            assert not got[200:].any()
    if spec.moe:
        assert ref.dropped > 0      # the comparison covers the drops


def test_capacity_rule():
    spec = hm.spec_of(smoke_conf("olmoe-1b-7b"))   # 8 experts, top 2
    # 200 tokens: 200·2·1.25/8 + 1 = 63 → 64; few tokens: at least 4,
    # at most the tokens, rounded to 32.
    assert decoder.capacity(200, spec) == 64
    assert decoder.capacity(3, spec) == 32
    from repro_torch.configs import get_smoke
    from repro_torch.models.mlp import _capacity
    for t in (1, 3, 7, 64, 200, 1000, 4096):
        assert decoder.capacity(t, spec) == _capacity(
            t, get_smoke("olmoe-1b-7b"), 1.25)


def test_first_training_steps():
    conf, mix = smoke_conf("granite-3-2b"), smoke_mix("train-2k")
    spec = hm.spec_of(conf)
    losses, grads, moved = train.reference_steps(spec, mix, 5, "cpu")
    assert len(losses) == mix["first_steps"]
    assert all(np.isfinite(losses)) and all(v > 0 for v in moved.values())
    assert set(grads) == {n for n, _, _ in decoder.leaves(spec)}


def _routing_spec(**kw):
    return decoder.Spec(layers=1, d_model=4, heads=1, kv_heads=1,
                        head_dim=4, d_ff=4, vocab=8, padded_vocab=8,
                        tied=True, rope_theta=1e4, eps=1e-5, experts=4,
                        top_k=1, **kw)


def test_near_ties_mark_the_tied_tokens():
    spec = _routing_spec()
    # The router reads the first two coordinates as the logits of experts
    # 0 and 1 (experts 2 and 3 far below). Token 1 ties 0 and 1 within
    # the margin; token 2 is near but outside it.
    router = torch.zeros(4, 4)
    router[0, 0] = router[1, 1] = 1.0
    router[2, 2] = router[2, 3] = -5.0
    x = torch.tensor([[1.0, 0.0, 1.0, 0.0], [1.0, 1.0 - 3e-5, 1.0, 0.0],
                      [1.0, 1.0 - 3e-4, 1.0, 0.0], [0.0, 1.0, 1.0, 0.0]])
    marked, ties = decoder.near_ties(x, router, spec)
    assert ties == 1
    assert marked.tolist() == [False, True, False, False]


def test_near_ties_mark_a_full_experts_capacity_line():
    spec = _routing_spec()
    router = torch.zeros(4, 4)
    router[0, 0] = router[1, 1] = 1.0
    router[2, 2] = router[2, 3] = -5.0
    # 39 of 40 tokens choose expert 0, past its 32 slots; token 2 ties it
    # with expert 1, which has room. A swap moves expert 0's line, between
    # its 32nd and 33rd tokens (31 and 32).
    rows = [[1.0, 0.0, 1.0, 0.0]] * 40
    rows[2] = [1.0, 1.0 - 1e-5, 1.0, 0.0]
    rows[39] = [0.0, 1.0, 1.0, 0.0]
    assert decoder.capacity(40, spec) == 32
    marked, ties = decoder.near_ties(torch.tensor(rows), router, spec)
    assert ties == 1
    assert torch.nonzero(marked).squeeze(1).tolist() == [2, 31, 32]


def test_dense_check_leaves_nothing_out_and_takes_the_worst():
    conf = smoke_conf("granite-3-2b")
    spec = hm.spec_of(conf)
    weights = hm.make_weights(spec, 12, "cpu")
    m = hm.port_model(conf, weights)
    kept = []
    for uid, n in ((0, 40), (1, 90)):
        r = traffic.Sent(uid, n, 0.0)
        prompt = torch.as_tensor(traffic.prompt_tokens(5, uid, n, spec.vocab),
                                 dtype=torch.long)
        logits, caches = m.prefill(prompt[None], cache_len=128)
        r.token = int(logits[0, :spec.vocab].argmax())
        kept.append((r, logits, caches))
    checks, notes = prefill.check(spec, weights, kept, 5)
    assert notes["kv_rows_left_out"] == 0 and notes["logits_left_out"] == 0
    assert checks["kv_err"] < 1e-2
    # One row of the longer prompt wholly wrong: the worst sees it.
    kept[1][2]["v"][1, 0, 77] += 1.0
    bad, _ = prefill.check(spec, weights, kept, 5)
    assert bad["kv_err"] > 0.1 and bad["logit_err"] == checks["logit_err"]
