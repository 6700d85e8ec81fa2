"""The port's training slice against the reference, on the CPU.

Same inputs on both sides, made with numpy from a seed; the same weights,
drawn by the reference with ``jax.random`` and carried into the port
(``repro_torch.models.weights``). The smoke smollm-135m (2 layers,
d = 48) throughout.

Tolerances, with their reasons:

* attention 1e-5 (f32): the same blocked softmax, sums in another order;
* loss 1e-5 and gradients 1e-4 of each leaf's gradient norm: f32 sums in
  another order through two layers and a 512-column head;
* ``lr_at`` exactly: host arithmetic;
* one AdamW step 1e-6 (f32 state, relative to the largest value) and one
  bf16 unit for bf16 moments;
* compression within one quantum (``max|g + err| / 127``) of the
  reference, and the port's error exactly what its round trip dropped;
* three train steps, each from the reference's state: loss 1e-5 and
  ``grad_norm`` 1e-4 relative (1e-3 with compression, where a value near
  a half quantum may round either way), ``lr`` exactly; params and moments
  within 1e-4 of each leaf's largest value on all but 1e-3 of the
  elements (1e-2 with compression, whose flips a small leaf feels most),
  and every element within what one flipped rounding can move
  it (Adam's first update is the sign of a gradient, so a tiny gradient
  whose sign differs moves a weight by up to 2 lr; compression moves a
  moment or an error by a quantum);
* one AdamW step with bf16 state: the reference's XLA program on the CPU
  keeps the bf16 products in f32, so its weights are within one bf16 unit
  of the port's, which rounds to bf16.

The training launcher, checkpoints and B4's gradient guard are held in
``tests/test_torch_dryrun.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke as ref_get_smoke
from repro.models import RunConfig as RefRunConfig
from repro.models import attention as ref_attention
from repro.models import build_model as ref_build_model
from repro.models import transformer as ref_transformer
from repro.models.sharding import ShardingPlan
from repro.train import checkpoint as ref_ckpt
from repro.train import compression as ref_compression
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_step
from repro_torch.configs import get_config, get_smoke
from repro_torch.models import attention, build_model, transformer
from repro_torch.models import weights
from repro_torch.models.transformer import RunConfig
from repro_torch.train import checkpoint, compression, optimizer
from repro_torch.train import train_step as port_step

ATTN_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ref_flat(state):
    """The reference's checkpoint keys and arrays of a state."""
    keys, vals, _ = ref_ckpt._flatten_with_paths(_np(state))
    return dict(zip(keys, vals))


@functools.lru_cache(maxsize=None)
def _ref_pair(vocab_size, rc_items, seed):
    jcfg = ref_get_smoke("smollm-135m")
    if vocab_size is not None:
        jcfg = dataclasses.replace(jcfg, vocab_size=vocab_size)
    jmodel = ref_build_model(jcfg, plan=ShardingPlan.null(),
                             rc=RefRunConfig(**dict(rc_items)),
                             param_dtype=jnp.float32)
    params, _ = jmodel.init(jax.random.PRNGKey(seed))
    return jmodel, params


def _smoke_pair(vocab_size=None, rc=None, seed=0):
    """The reference's smoke model and params (built once per arguments)
    and a fresh port model holding the same weights."""
    rc = rc or {}
    jmodel, params = _ref_pair(vocab_size, tuple(sorted(rc.items())), seed)
    cfg = get_smoke("smollm-135m")
    if vocab_size is not None:
        cfg = dataclasses.replace(cfg, vocab_size=vocab_size)
    model = weights.from_reference_params(cfg, _np(params), device="cpu",
                                          rc=RunConfig(**rc))
    return jmodel, params, model


def _batch(vocab, b, s, seed, ignore=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    if ignore:
        labels[rng.random((b, s)) < ignore] = -1
    return tokens, labels


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sq,sk,causal,qc,kc", [
    (37, 37, True, 16, 8),       # ragged in both block sizes
    (24, 40, True, 8, 16),       # causal rows offset by Sk - Sq
    (21, 33, False, 512, 1024),  # the default blocks, one each
])
def test_naive_and_chunked_attention_match_reference(sq, sk, causal, qc, kc):
    rng = np.random.default_rng(sq + sk)
    q = rng.standard_normal((2, sq, 2, 3, 16)).astype(np.float32)
    k = rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
    w = rng.standard_normal((2, sq, 2, 3, 16)).astype(np.float32)
    off = sk - sq if causal else 0
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))

    @jax.jit
    def ref_chunked(a, b, c):
        return ref_attention._chunked_attention(a, b, c, causal, off,
                                                q_chunk=qc, kv_chunk=kc)

    @jax.jit
    def ref_naive(a, b, c):
        return ref_attention._naive_attention(a, b, c, causal, off)

    for ref_fn, port_fn in (
            (ref_naive, lambda a, b, c: attention.naive_attention(
                a, b, c, causal, off)),
            (ref_chunked, lambda a, b, c: attention.chunked_attention(
                a, b, c, causal, off, q_chunk=qc, kv_chunk=kc))):
        want = ref_fn(jq, jk, jv)
        got = port_fn(tq, tk, tv)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=ATTN_TOL)
        # Gradients of <out, w> w.r.t. q, k and v.
        jgrads = jax.jit(jax.grad(
            lambda a, b, c: jnp.sum(ref_fn(a, b, c) * w),
            argnums=(0, 1, 2)))(jq, jk, jv)
        tgrads = torch.autograd.grad((port_fn(tq, tk, tv)
                                      * torch.from_numpy(w)).sum(),
                                     (tq, tk, tv))
        for g, jg in zip(tgrads, jgrads):
            np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0,
                                       atol=ATTN_TOL)


@pytest.mark.parametrize("impl", ["naive", "chunked", "pallas"])
def test_attention_impls_match_reference(impl):
    jmodel, params, model = _smoke_pair()
    cfg, jcfg = model.cfg, jmodel.cfg
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 19, cfg.d_model)).astype(np.float32)
    pos = np.arange(19, dtype=np.int32)
    p0 = jax.tree.map(lambda a: a[0], params["blocks"]["attn"])
    want = ref_attention.attention(p0, jcfg, ShardingPlan.null(),
                                   jnp.asarray(x), jnp.asarray(pos),
                                   impl=impl).out
    got = attention.attention(model.blocks[0].attn, cfg, torch.from_numpy(x),
                              torch.from_numpy(pos), impl=impl).out
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=ATTN_TOL)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def test_chunked_cross_entropy_matches_reference():
    """Padded vocabulary (500 of 512 columns), ignored labels and a chunk
    (16) that does not divide S (37); value and both gradients."""
    rng = np.random.default_rng(7)
    hidden = rng.standard_normal((2, 37, 24)).astype(np.float32)
    head = (rng.standard_normal((24, 512)) / 5).astype(np.float32)
    labels = rng.integers(0, 500, (2, 37)).astype(np.int32)
    labels[:, ::5] = -1

    def ref_fn(h, w):
        return ref_transformer.chunked_cross_entropy(
            h, w, jnp.asarray(labels), 500, chunk=16)

    want, (jgh, jgw) = jax.value_and_grad(ref_fn, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(head))
    th = torch.from_numpy(hidden).requires_grad_(True)
    tw = torch.from_numpy(head).requires_grad_(True)
    got = transformer.chunked_cross_entropy(
        th, tw, torch.from_numpy(labels).long(), 500, chunk=16)
    gh, gw = torch.autograd.grad(got, (th, tw))
    assert abs(got.item() - float(want)) <= LOSS_TOL * abs(float(want))
    for g, jg in ((gh, jgh), (gw, jgw)):
        jg = np.asarray(jg)
        assert np.abs(g.numpy() - jg).max() <= GRAD_TOL * np.linalg.norm(jg)
    # Every label ignored: the mean divides by one, not by zero.
    none = transformer.chunked_cross_entropy(
        th, tw, torch.full((2, 37), -1), 500, chunk=16)
    assert none.item() == 0.0


@pytest.mark.parametrize("impl,remat", [("naive", False), ("chunked", True)])
def test_loss_fn_and_every_leaf_gradient_match_reference(impl, remat):
    rc = dict(attn_impl=impl, remat=remat, loss_chunk=12)
    jmodel, params, model = _smoke_pair(vocab_size=500, rc=rc, seed=2)
    tokens, labels = _batch(500, 3, 29, seed=3, ignore=0.2)
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    want, jgrads = jax.value_and_grad(jmodel.loss)(params, batch)
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    got = model.loss({"tokens": torch.from_numpy(tokens),
                      "labels": torch.from_numpy(labels)})
    grads = dict(zip(named, torch.autograd.grad(got, list(named.values()))))
    assert abs(got.item() - float(want)) <= LOSS_TOL * abs(float(want))
    want_g = weights.stacked_arrays(".params", grads)
    for key, jg in _ref_flat(jgrads).items():
        g = want_g[".params/" + key]
        assert np.abs(g - jg).max() <= GRAD_TOL * np.linalg.norm(jg), key


# ---------------------------------------------------------------------------
# optimizer and compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("oc", [
    dict(lr=1e-3, warmup_steps=5, total_steps=20),   # launch/train.py's
    dict(lr=1e-3, warmup_steps=5, total_steps=10),
    dict(),                                          # the defaults
    dict(lr=3e-3, warmup_steps=7, total_steps=333, min_lr_ratio=0.05),
    dict(warmup_steps=0, total_steps=1),
])
def test_lr_at_equals_reference_exactly(oc):
    want_fn = jax.jit(lambda s: ref_opt.lr_at(ref_opt.OptConfig(**oc), s))
    port = optimizer.OptConfig(**oc)
    steps = range(port.total_steps + 6)
    want = np.array([np.asarray(want_fn(jnp.int32(s))) for s in steps])
    got = np.array([optimizer.lr_at(port, s) for s in steps])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
def test_decay_mask_equals_reference_on_every_leaf(full):
    jcfg = (ref_get_config if full else ref_get_smoke)("smollm-135m")
    cfg = (get_config if full else get_smoke)("smollm-135m")
    jmodel = ref_build_model(jcfg, plan=ShardingPlan.null(),
                             param_dtype=jnp.float32)
    abstract, _ = jmodel.abstract_params()
    want = {"/".join(str(k) for k in path): ref_opt._decay_mask(path)
            for path, _ in jax.tree_util.tree_flatten_with_path(abstract)[0]}
    model = build_model(cfg, device="meta")
    got = {}
    for name, _ in model.named_parameters():
        path, _ = weights.reference_path(name)
        key = weights.reference_key(".params", path)[len(".params/"):]
        got.setdefault(key, set()).add(optimizer._decay_mask(name))
    assert got.keys() == want.keys()
    assert {k: v.pop() for k, v in got.items() if len(v) == 1} == want
    assert not want["['ln_f']"] and want["['embed']"]


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_opt_update_one_step_matches_reference(state_dtype):
    rng = np.random.default_rng(11)
    jmodel, params, model = _smoke_pair(seed=4)
    oc = dict(lr=1e-2, warmup_steps=2, total_steps=10, state_dtype=state_dtype)
    jparams = params
    jopt = ref_opt.opt_init(jparams, ref_opt.OptConfig(**oc))
    jgrads = jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)
                              * 0.3), jparams)
    # A non-zero starting state, the same on both sides.
    jopt = jopt._replace(
        mu=jax.tree.map(lambda g: (g * 0.1).astype(jopt.mu["embed"].dtype),
                        jgrads),
        nu=jax.tree.map(lambda g: (g * g * 0.01).astype(
            jopt.nu["embed"].dtype), jgrads),
        step=jnp.int32(3))
    want_p, want_o, want_m = jax.jit(
        lambda g, o, p: ref_opt.opt_update(g, o, p, ref_opt.OptConfig(**oc))
    )(jgrads, jopt, jparams)

    named = dict(model.named_parameters())
    ocp = optimizer.OptConfig(**oc)
    state = optimizer.opt_init(named, ocp)
    flat = _ref_flat(ref_step.TrainState(params=jparams, opt=jopt, err=None))
    step = weights.load_train_state_arrays(flat, named, state.mu, state.nu)
    state = state._replace(step=step)
    grads = {n: torch.zeros_like(p) for n, p in named.items()}
    weights.load_stacked(".params", {".params/" + k: v for k, v in
                                     _ref_flat(jgrads).items()}, grads)
    _, new, metrics = optimizer.opt_update(grads, state, named, ocp)
    assert new.step == 4
    assert float(metrics["lr"]) == float(want_m["lr"])
    assert abs(float(metrics["grad_norm"]) - float(want_m["grad_norm"])) \
        <= 1e-6 * float(want_m["grad_norm"])
    got = weights.train_state_arrays(named, new.mu, new.nu, new.step)
    want = _ref_flat(ref_step.TrainState(params=want_p, opt=want_o,
                                         err=None))
    for key, w in want.items():
        g = got[key]
        if key == weights.STEP_KEY:
            assert int(g) == int(w)
            continue
        if g.dtype == np.dtype("V2"):       # bf16 words: one unit apart
            g = weights.from_numpy(g, torch.float32).numpy()
            w = w.astype(np.float32)
            assert (np.abs(g - w) <= np.abs(w) * 2.0**-7 + 1e-30).all(), key
        elif state_dtype == "bfloat16":
            # The reference's XLA program keeps these bf16 products in f32
            # on the CPU; the port rounds p and the result to bf16.
            assert (np.abs(g - w) <= np.abs(w) * 2.0**-7 + 1e-6).all(), key
        else:
            assert np.abs(g - w).max() <= 1e-6 * max(1.0, np.abs(w).max()), \
                key


def test_compress_decompress_within_one_quantum_and_carries_its_error():
    rng = np.random.default_rng(13)
    shapes = {"a": (5, 7), "b": (11,), "c": (3, 4, 2)}
    g = {n: (rng.standard_normal(s) * 10 ** rng.uniform(-4, 1)).astype(
        np.float32) for n, s in shapes.items()}
    e = {n: (rng.standard_normal(s) * 1e-3).astype(np.float32)
         for n, s in shapes.items()}
    want_d, want_e = ref_compression.compress_decompress(
        {n: jnp.asarray(v) for n, v in g.items()},
        {n: jnp.asarray(v) for n, v in e.items()})
    got_d, got_e = compression.compress_decompress(
        {n: torch.from_numpy(v) for n, v in g.items()},
        {n: torch.from_numpy(v) for n, v in e.items()})
    for n in shapes:
        target = g[n] + e[n]
        quantum = np.abs(target).max() / 127.0
        assert np.abs(got_d[n].numpy() - np.asarray(want_d[n])).max() \
            <= quantum * 1.0001
        np.testing.assert_array_equal(got_e[n].numpy(),
                                      target - got_d[n].numpy())
        assert np.abs(got_e[n].numpy()).max() <= quantum / 2 * 1.0001
        # the levels are integers in [-127, 127] times one scale
        levels = got_d[n].numpy() / quantum
        assert np.abs(levels - np.round(levels)).max() < 1e-3


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


def _carry(state, jstate):
    """The port state holding the reference state's values."""
    step = weights.load_train_state_arrays(
        _ref_flat(jstate), state.params, state.opt.mu, state.opt.nu,
        state.err)
    return state._replace(opt=state.opt._replace(step=step))


def _close_most(got, want, key, bound, share, scale):
    """Every element within ``bound``; all but ``share`` of them within
    ``STEP_TOL`` of ``scale`` (Adam's update is the sign of a tiny
    gradient, and int8 compression rounds a value near a half quantum
    either way, so a few elements may move by the bound)."""
    scale = max(1e-3, scale)
    diff = np.abs(got - want)
    assert diff.max() <= bound + 1e-6 * scale, key
    assert (diff > STEP_TOL * scale).mean() <= share, key


@pytest.mark.parametrize("accum,compress", [(1, False), (2, False),
                                            (1, True), (2, True)])
def test_train_step_matches_reference(accum, compress):
    """Three steps, each from the reference's state carried into the port
    (so one step's rounding does not compound into the next's)."""
    jmodel, _, _ = _smoke_pair()
    oc = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    sc = dict(accum_steps=accum, compress_cross_pod=compress)
    jstate = ref_step.init_train_state(jmodel, jax.random.PRNGKey(1),
                                       ref_opt.OptConfig(**oc),
                                       ref_step.StepConfig(**sc))
    jfn = jax.jit(ref_step.make_train_step(
        jmodel, ref_opt.OptConfig(**oc), ref_step.StepConfig(**sc)))

    model = build_model(get_smoke("smollm-135m"), device="cpu",
                        rc=RunConfig())
    state = port_step.init_train_state(model, optimizer.OptConfig(**oc),
                                       port_step.StepConfig(**sc))
    fn = port_step.make_train_step(model, optimizer.OptConfig(**oc),
                                   port_step.StepConfig(**sc))
    for i in range(3):
        state = _carry(state, jstate)
        tokens, labels = _batch(512, 4, 24, seed=20 + i, ignore=0.1)
        jstate, jm = jfn(jstate, {"tokens": jnp.asarray(tokens),
                                  "labels": jnp.asarray(labels)})
        state, m = fn(state, {"tokens": torch.from_numpy(tokens),
                              "labels": torch.from_numpy(labels)})
        assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_TOL * abs(
            float(jm["loss"])), i
        # Compression may round a few elements a quantum the other way.
        gtol = 1e-3 if compress else STEP_TOL
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
            gtol * float(jm["grad_norm"]), i
        assert float(m["lr"]) == float(jm["lr"])
        assert state.opt.step == int(jstate.opt.step) == i + 1
        lr = float(jm["lr"])
        got, want = checkpoint._arrays(state), _ref_flat(jstate)
        assert got.keys() == want.keys()
        for key, w in want.items():
            if key == weights.STEP_KEY:
                continue
            # A flipped update moves a weight by at most 2 lr. With
            # compression a moment or an error may move by a quantum, up to
            # twice the leaf's largest error; without, by the sums' last
            # bits.
            bound = 2.0 * lr * 1.001 if key.startswith(".params") else (
                max(1e-3, float(np.abs(w).max())) * (
                    2.0 if compress else STEP_TOL))
            # An error is at most half a quantum, 1/254 of the leaf's
            # largest gradient, which sets the scale of its sums' bits.
            scale = float(np.abs(w).max()) * (
                254.0 if key.startswith(".err") else 1.0)
            _close_most(got[key], w, key, bound,
                        share=1e-2 if compress else 1e-3, scale=scale)


def test_train_step_refuses_a_batch_accumulation_does_not_divide():
    model = build_model(get_smoke("smollm-135m"), device="cpu")
    oc = optimizer.OptConfig()
    sc = port_step.StepConfig(accum_steps=3)
    state = port_step.init_train_state(model, oc, sc)
    tokens, labels = _batch(512, 4, 8, seed=0)
    with pytest.raises(ValueError, match="multiple"):
        port_step.make_train_step(model, oc, sc)(
            state, {"tokens": torch.from_numpy(tokens),
                    "labels": torch.from_numpy(labels)})
