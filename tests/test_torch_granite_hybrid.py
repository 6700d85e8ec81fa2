"""granite-4.0-h-small (the port's hybrid_moe family) against its plain
reference (``src/plain_reference/granite_hybrid.py``), on the CPU at the
smoke size with seeded random weights.

The port serves it through ``Model.prefill``, ``Model.decode_step`` and
``ContinuousBatcher``; the reference is a plain float32 forward pass of the
published equations, written apart from ``models/``. Both read the same
tensors. Tolerances, each over the reference's own scale:

* ``TOL`` = 1e-4, for logits (over their root mean square), key and value
  rows (over each row's norm), conv and SSM states (over their norm) and
  layer outputs: both sides compute in float32 and differ only in the
  order of their sums (the port's chunked scan against the reference's
  blockwise recurrence, batched expert products against one expert at a
  time), some 1e-6 here; the port built in bfloat16 lands 1e-2 off and
  fails it (``test_bf16_program_fails_the_tolerance``).
* ``FLIP`` = 1e-2: a published scalar or NoPE flipped must move the
  logits by at least this, a hundred times ``TOL``.

Routing is not continuous: every test that routes with dropping capacity
asserts that the reference marks no near-tie, so the tolerances never
pass over a swapped expert.
"""

import dataclasses
import math
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plain_reference import granite_hybrid as ref
from repro.configs import get_smoke as ref_get_smoke
from repro.models import ssm as ref_ssm
from repro_torch import spans
from repro_torch.configs import (ALL_ARCH_NAMES, ARCH_NAMES, PORT_ARCHS,
                                 all_cells, get_config, get_smoke)
from repro_torch.configs.base import HybridMoEConfig, ModelConfig
from repro_torch.models import build_model
from repro_torch.models import ssm as port_ssm
from repro_torch.models.common import attach_axes
from repro_torch.models.mlp import MoE, mlp, moe
from repro_torch.models.transformer import RunConfig
from repro_torch.serve.batching import ContinuousBatcher, Request

ARCH = "granite-4.0-h-small"
TOL = 1e-4
FLIP = 1e-2
SSD_CHUNK = 16
TOKEN_CHUNK = 128
ROOT = Path(__file__).resolve().parent.parent


def spec_of(cfg: HybridMoEConfig, capacity: float = 1.25,
            token_chunk: int = TOKEN_CHUNK) -> ref.Spec:
    d_in = cfg.ssm_expand * cfg.d_model
    return ref.Spec(
        layer_types=cfg.layer_types, d_model=cfg.d_model,
        heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, vocab=cfg.vocab_size,
        padded_vocab=cfg.padded_vocab, eps=cfg.norm_eps,
        ssm_heads=d_in // cfg.ssm_head_dim, ssm_head_dim=cfg.ssm_head_dim,
        ssm_state=cfg.ssm_state, conv_k=port_ssm.CONV_K, chunk=SSD_CHUNK,
        experts=cfg.num_experts, held=cfg.local_experts,
        first=cfg.experts_first, top_k=cfg.experts_per_tok,
        expert_ff=cfg.moe_d_ff, shared_ff=cfg.shared_expert_d_ff,
        embedding_multiplier=cfg.embedding_multiplier,
        attention_multiplier=cfg.attention_multiplier or
        1 / math.sqrt(cfg.head_dim),
        residual_multiplier=cfg.residual_multiplier,
        logits_scaling=cfg.logits_scaling, capacity_factor=capacity,
        token_chunk=token_chunk)


def draw(spec: ref.Spec, seed: int) -> dict:
    """Seeded weights by the reference's names: matrices N(0, 1/fan_in),
    norm scales and ``D`` near one, Mamba2's published A and dt draws."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, kind in ref.leaves(spec):
        if kind == "ones":
            t = 1.0 + 0.1 * torch.randn(shape, generator=g)
        elif kind == "A_log":
            t = torch.empty(shape).uniform_(1.0, 16.0, generator=g).log()
        elif kind == "dt_bias":
            dt = torch.exp(torch.empty(shape).uniform_(
                math.log(1e-3), math.log(1e-1), generator=g))
            t = dt + torch.log(-torch.expm1(-dt))
        else:
            t = torch.randn(shape, generator=g) / math.sqrt(kind)
        out[name] = t
    return out


def port(cfg: HybridMoEConfig, weights: dict, capacity: float = 1.25,
         dtype: torch.dtype = torch.float32):
    """The port's model of ``cfg`` holding ``weights`` (in ``dtype``; the
    router and the Mamba2 scalars kept in float32, as the port keeps
    them)."""
    rc = RunConfig(moe_capacity=capacity, moe_token_chunk=TOKEN_CHUNK,
                   ssd_chunk=SSD_CHUNK)
    model = build_model(cfg, device="meta", rc=rc)
    keep = ("router", "A_log", ".D", "dt_bias")
    model.load_state_dict({n: t if n.endswith(keep) else t.to(dtype)
                           for n, t in weights.items()}, strict=True,
                          assign=True)
    attach_axes(model, model.param_axes)
    return model


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got.float() - want)
                 / torch.linalg.vector_norm(want))


def prompt(n: int, seed: int = 1) -> torch.Tensor:
    return torch.randint(0, 512, (n,), generator=torch.Generator()
                         .manual_seed(seed))


@pytest.fixture(scope="module")
def smoke():
    cfg = get_smoke(ARCH)
    spec = spec_of(cfg)
    return cfg, spec, draw(spec, 7)


def _logit_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want).abs().max()
                 / torch.sqrt(torch.mean(want * want)))


@pytest.mark.parametrize("length, capacity", [(40, 1.25), (150, 0.25)])
def test_prefill_matches_reference(smoke, length, capacity):
    """Logits, every attention layer's K/V rows, every Mamba2 layer's
    final conv and SSM state; 150 tokens route in two chunks of 128, the
    last at a whole chunk's capacity (the reference pads it), and at
    capacity 0.25 drop assignments on both sides."""
    cfg, spec, w = smoke
    spec = dataclasses.replace(spec, capacity_factor=capacity)
    tokens = prompt(length)
    r = ref.prefill(w, spec, tokens)
    assert r.near_ties == 0 and (r.dropped > 0) == (capacity < 1)
    logits, c = port(cfg, w, capacity).prefill(
        tokens[None], cache_len=length + 8, cache_dtype=torch.float32)
    assert _logit_err(logits[0, :cfg.vocab_size], r.logits) < TOL
    for a in range(len(spec.attention_layers)):
        for name, want in (("k", r.keys[a]), ("v", r.values[a])):
            got = c[name][a, 0]
            assert rel(got[:length], want) < TOL
            assert not got[length:].any()
    assert len(r.conv_states) == c["conv"].shape[0] == 3
    for m in range(len(spec.mamba_layers)):
        assert rel(c["conv"][m, 0], r.conv_states[m]) < TOL
        assert rel(c["ssm"][m, 0], r.ssm_states[m]) < TOL


def test_bf16_program_fails_the_tolerance(smoke):
    cfg, spec, w = smoke
    tokens = prompt(150)
    r = ref.prefill(w, spec, tokens)
    logits, c = port(cfg, w, dtype=torch.bfloat16).prefill(
        tokens[None], cache_len=160, cache_dtype=torch.float32)
    errs = [_logit_err(logits[0, :cfg.vocab_size], r.logits),
            rel(c["ssm"][0, 0], r.ssm_states[0]),
            rel(c["k"][0, 0, :150], r.keys[0])]
    assert max(errs) > 10 * TOL, errs


def test_decode_steps_match_the_full_forward(smoke):
    """Prefill 40 tokens, then 8 ``decode_step`` s through both kinds of
    cache, each against the reference's full forward over the same tokens
    (capacity that drops nothing, so routing one token or all agree)."""
    cfg, spec, w = smoke
    full = dataclasses.replace(spec, capacity_factor=4.0)
    tokens = prompt(48, seed=3)
    want = ref.forward_logits(w, full, tokens)
    model = port(cfg, w, capacity=4.0)
    logits, c = model.prefill(tokens[None, :40], cache_len=64,
                              cache_dtype=torch.float32)
    assert _logit_err(logits[0, :cfg.vocab_size], want[39]) < TOL
    for i in range(40, 48):
        logits, c = model.decode_step(tokens[i:i + 1], c, i)
        assert _logit_err(logits[0, :cfg.vocab_size], want[i]) < TOL


def test_forward_and_loss_match_the_full_forward(smoke):
    """``Model.forward`` (the training path: chunked attention, the scan
    without a cache) gives the reference's logits at every position
    through the head, and ``Model.loss`` their mean cross-entropy."""
    cfg, spec, w = smoke
    full = dataclasses.replace(spec, capacity_factor=4.0)
    tokens = prompt(48, seed=6)
    want = ref.forward_logits(w, full, tokens)
    model = port(cfg, w, capacity=4.0)
    with torch.no_grad():
        hidden = model.forward(tokens[None])[0]
        got = (hidden / cfg.logits_scaling) @ model.embed[:cfg.vocab_size].T
        assert _logit_err(got, want) < TOL
        labels = torch.roll(tokens, -1)
        loss = model.loss({"tokens": tokens[None], "labels": labels[None]})
    assert float(loss) == pytest.approx(float(torch.nn.functional
                                              .cross_entropy(want, labels)),
                                        rel=TOL)


def test_serving_launcher_runs_the_smoke_model():
    from repro_torch.launch import serve

    reqs, stats = serve.run(ARCH, smoke=True, n_requests=3, max_new=4,
                            device="cpu")
    assert stats.prefills == 3 and all(r.done for r in reqs)


def test_batcher_serves_like_reference(smoke):
    """``ContinuousBatcher`` prefills each request into its slot and
    decodes the slots together: every token it emits is the reference's
    best within ``TOL`` of the reference's logits."""
    cfg, spec, w = smoke
    full = dataclasses.replace(spec, capacity_factor=4.0)
    batcher = ContinuousBatcher(port(cfg, w, capacity=4.0), max_slots=2,
                                cache_len=48)
    reqs = [Request(uid=u, prompt=prompt(20 + 7 * u, seed=10 + u).numpy()
                    .astype(np.int32), max_new_tokens=5) for u in range(3)]
    for r in reqs:
        batcher.admit(r)
    done = batcher.flush()
    assert sorted(r.uid for r in done) == [0, 1, 2]
    for r in reqs:
        seq = torch.as_tensor(np.concatenate([r.prompt, r.out_tokens[:-1]]))
        lg = ref.forward_logits(w, full, seq)[len(r.prompt) - 1:]
        scale = torch.sqrt(torch.mean(lg * lg))
        for row, tok in zip(lg, r.out_tokens):
            assert row.max() - row[tok] <= TOL * scale


def test_expert_shares_add_up_to_the_whole_layer():
    """At a capacity that drops nothing, the 8 shares of 2 experts each
    (each routing over all 16 with the whole layer's capacity and adding
    its own experts' part), with the shared expert counted once, give the
    reference's layer holding all 16 experts."""
    cfg = dataclasses.replace(get_smoke(ARCH), experts_held=0)
    spec = spec_of(cfg, capacity=4.0)
    w = draw(spec, 11)
    h = torch.randn(90, cfg.d_model, generator=torch.Generator()
                    .manual_seed(5))
    p = "blocks.0."
    want = ref.feed_forward(w, p, spec, h)[0]
    total = mlp(types.SimpleNamespace(wi=w[p + "shared.wi"],
                                      wg=w[p + "shared.wg"],
                                      wo=w[p + "shared.wo"]), h)
    for j in range(8):
        share = dataclasses.replace(cfg, experts_held=2, experts_first=2 * j)
        block = types.SimpleNamespace(
            router=w[p + "moe.router"],
            **{k: w[p + "moe." + k][2 * j:2 * j + 2]
               for k in ("wi", "wg", "wo")})
        part = moe(block, h[None], share, capacity_factor=4.0,
                   token_chunk=TOKEN_CHUNK)[0]
        assert part.abs().sum() > 0
        total = total + part
    assert rel(total, want) < TOL
    held = dataclasses.replace(cfg, experts_held=2, experts_first=4)
    assert MoE(held, None, torch.float32, "meta").wi.shape[0] == 2
    assert MoE(held, None, torch.float32, "meta").router.shape[1] == 16


@pytest.mark.parametrize("flip", [
    {"nope": False}, {"embedding_multiplier": 1.0},
    {"attention_multiplier": 0.0}, {"residual_multiplier": 1.0},
    {"logits_scaling": 1.0}])
def test_nope_and_each_multiplier_change_the_output(smoke, flip):
    """Each published departure from a plain decoder is computed: flipped
    alone in the port, the logits leave the reference's."""
    cfg, spec, w = smoke
    tokens = prompt(40, seed=4)
    want = ref.prefill(w, spec, tokens).logits
    same = port(cfg, w).prefill(tokens[None], cache_len=40)[0]
    assert _logit_err(same[0, :cfg.vocab_size], want) < TOL
    flipped = port(dataclasses.replace(cfg, **flip), w).prefill(
        tokens[None], cache_len=40)[0]
    assert _logit_err(flipped[0, :cfg.vocab_size], want) > FLIP


def test_published_conv_over_x_b_c_matches_reference(smoke):
    """One Mamba2 mixer: the conv over ``[x | B | C]`` with its bias, then
    SiLU on all three, as the reference computes it."""
    cfg, spec, w = smoke
    model = port(cfg, w)
    p = "blocks.0."
    h = torch.randn(70, cfg.d_model, generator=torch.Generator()
                    .manual_seed(2))
    want, conv, state = ref.mamba(w, p, spec, h)
    mixer = model.blocks[0].mamba
    assert mixer.conv_w.shape == (4, spec.conv_dim)
    assert mixer.conv_b.shape == (spec.conv_dim,)
    got, cache = port_ssm.mamba_block(mixer, cfg, h[None], chunk=SSD_CHUNK)
    assert rel(got[0], want) < TOL
    assert rel(cache.conv[0], conv) < TOL
    assert rel(cache.ssm[0], state) < TOL
    plain = dataclasses.replace(cfg, ssm_conv_xbc=False)
    mixer.conv_w = torch.nn.Parameter(w[p + "mamba.conv_w"][:, :spec.d_inner],
                                      requires_grad=False)
    assert rel(port_ssm.mamba_block(mixer, plain, h[None],
                                    chunk=SSD_CHUNK)[0][0], want) > FLIP


def test_zamba2_conv_stays_x_only_and_equal_to_the_jax_package():
    """zamba2's Mamba2 keeps its conv over x alone with no bias, and its
    mixer computes what the JAX package's does."""
    cfg = get_smoke("zamba2-2.7b")
    model = build_model(cfg, device="cpu")
    mixer = model.mamba_groups[0][0].mamba
    d_in = cfg.ssm_expand * cfg.d_model
    assert mixer.conv_w.shape == (4, d_in) and not hasattr(mixer, "conv_b")
    g = torch.Generator().manual_seed(3)
    mixer.A_log.data = torch.rand(mixer.A_log.shape, generator=g)
    mixer.dt_bias.data = torch.randn(mixer.dt_bias.shape, generator=g)
    x = torch.randn(1, 50, cfg.d_model, generator=g)
    got, cache = port_ssm.mamba_block(mixer, cfg, x, chunk=16)
    params = {n: jnp.asarray(t.numpy()) for n, t in mixer.named_parameters()}
    want, jcache = ref_ssm.mamba_block(params, ref_get_smoke("zamba2-2.7b"),
                                       jnp.asarray(x.numpy()), chunk=16)
    for a, b in ((got, want), (cache.conv, jcache.conv),
                 (cache.ssm, jcache.ssm)):
        assert rel(a, torch.from_numpy(np.asarray(b))) < TOL


def test_spans_and_counter_once_per_layer_of_their_kind(smoke):
    cfg, spec, w = smoke
    model = port(cfg, w)
    spans.clear()
    spans.enable()
    try:
        model.prefill(prompt(40)[None], cache_len=48)
    finally:
        spans.disable()
    names = [r.name for r in spans.records()]
    counts = spans.counters()
    spans.clear()
    n_mamba = cfg.layer_types.count("mamba")
    assert names.count("mamba") == names.count("ssd") == n_mamba == 3
    assert names.count("attn") == cfg.num_layers - n_mamba
    assert names.count("moe.shared") == names.count("ffn") == cfg.num_layers
    assert counts["ssd.tokens"] == 40 * n_mamba


def test_published_configuration_and_registry():
    cfg = get_config(ARCH)
    assert isinstance(cfg, HybridMoEConfig) and cfg.family == "hybrid_moe"
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.vocab_size, cfg.padded_vocab) == \
        (40, 4096, 32, 8, 128, 100352, 100352)
    assert [i for i, t in enumerate(cfg.layer_types) if t == "attention"] \
        == [5, 15, 25, 35]
    assert (cfg.num_experts, cfg.local_experts, cfg.experts_per_tok,
            cfg.moe_d_ff, cfg.shared_expert_d_ff) == (72, 72, 10, 768, 1536)
    assert (cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_expand) == (128, 64, 2)
    assert port_ssm.ssm_dims(cfg) == (8192, 128, 128)
    assert port_ssm.conv_width(cfg) == 8448
    assert (cfg.embedding_multiplier, cfg.attention_multiplier,
            cfg.residual_multiplier, cfg.logits_scaling) == \
        (12.0, 1 / 128, 0.22, 16.0)
    assert cfg.nope and cfg.ssm_conv_xbc and cfg.tie_embeddings
    assert round(cfg.param_count() / 1e8) == 322
    card = dataclasses.replace(cfg, experts_held=9)
    assert round(card.param_count() / 1e7) == 843
    model = build_model(card, device="meta")
    assert sum(t.numel() for t in model.parameters()) == \
        card.param_count() + cfg.d_model
    assert ARCH in PORT_ARCHS and ARCH in ALL_ARCH_NAMES
    assert ARCH not in ARCH_NAMES and len(all_cells()) == 40
    assert get_smoke(ARCH).family == "hybrid_moe"


def test_defaults_add_nothing_and_bad_fields_are_refused():
    """A plain ``ModelConfig`` reads every hybrid_moe field at the value
    that adds no operation; a ``HybridMoEConfig`` refuses layer types and
    expert blocks that do not fit."""
    plain = get_config("granite-3-2b")
    assert type(plain) is ModelConfig
    assert (plain.layer_types, plain.shared_expert_d_ff, plain.nope,
            plain.ssm_conv_xbc, plain.embedding_multiplier,
            plain.attention_multiplier, plain.residual_multiplier,
            plain.logits_scaling, plain.experts_held, plain.experts_first) \
        == ((), 0, False, False, 1.0, 0.0, 1.0, 1.0, 0, 0)
    assert "layer_types" not in ModelConfig.__dataclass_fields__
    assert get_config("olmoe-1b-7b").local_experts == 64
    smoke = get_smoke(ARCH)
    with pytest.raises(ValueError, match="layer_types"):
        dataclasses.replace(smoke, layer_types=("mamba",) * 3)
    with pytest.raises(ValueError, match="layer_types"):
        dataclasses.replace(smoke, layer_types=("mamba", "rwkv") * 2)
    with pytest.raises(ValueError, match="experts"):
        dataclasses.replace(smoke, experts_held=4, experts_first=14)


def test_run_config_fields_of_the_family():
    RunConfig(moe_capacity=2.0, ssd_chunk=256).check("hybrid_moe")
    with pytest.raises(ValueError):
        RunConfig(rwkv_impl="scan").check("hybrid_moe")


def test_plain_reference_copy_in_the_benchmark_is_the_same_file():
    assert (ROOT / "src/plain_reference/granite_hybrid.py").read_bytes() == \
        (ROOT / "portbench/reference/granite_hybrid.py").read_bytes()


def test_reference_imports_nothing_of_the_port():
    src = (ROOT / "src/plain_reference/granite_hybrid.py").read_text()
    imports = [ln for ln in src.splitlines()
               if ln.startswith(("import ", "from "))]
    assert imports == ["from __future__ import annotations",
                       "import dataclasses", "import math",
                       "from typing import List, Tuple", "import torch"]
