"""Multi-head latent attention in the port (``models/mla.py``, the MLA
branches of ``models/model.py``, ``serve/engine.py`` over the latent cache)
and its latent-MQA kernel (``kernels/mla_attention.py``,
``csrc/mla_attention.cu``), against the JAX package.

CPU (runs anywhere), f32 at the reduced widths (latent 32 + rope 8, 4 heads):
- ``ref.mla_ragged_attention`` against the JAX package's
  ``ops.mla_ragged_attention`` in ``interpret`` mode (the Pallas ragged
  kernel as latent MQA) and its ``ref``: 12 tokens over 3 of 4 slots, a
  prefill chunk, singletons and one padding token, through a ``pack_slots``
  indirection (the JAX model gathers the packed rows, the port reads the
  full cache at the global slot). Live tokens only: a padding token (pos >=
  S_max) gets the average of its whole slot from JAX's kernel and ref, zeros
  from the port's kernel, and nothing reads it.
- ``mla_apply`` (return_kv), ``mla_decode`` and ``mla_packed`` against the
  JAX functions on reduced minicpm3-4b (q LoRA) and on a dense config with
  reduced deepseek-v2-lite's MLA sub-config (dense wq); ``LM.prefill``,
  ``decode_step`` and ``packed_step`` logits against the JAX ``LM``; the
  engine's greedy streams against the JAX ``ServeEngine``'s at the default
  and a small prefill budget; the refusals of the latent cache (paged,
  quantized KV, int8 weights), of the unported families and of a moe
  config without its MoEConfig; the kernel's
  plan and domain.

Tolerances: 1e-5 absolute for the attention functions (f32, summation
order only; the JAX interpret kernel and ref are 7e-7 apart here), 1e-4 for
logits (two layers of f32 matmuls summed in different orders, as
``tests/test_torch_model.py``); streams must be equal.

CUDA (``-m cuda``, skipped without a card): the kernel against its plain
version at the three widths (minicpm3-4b's, deepseek-v2-lite's, the reduced
configs'), the serving pack at forced spans, one CUDA graph replayed
bitwise, offset views of the cache taken and a misaligned one refused, and
the refusal of a width outside the domain. Tolerances are
``chip_smoke.py``'s: 1e-4 at f32, 2e-2 at a bf16 output.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.configs import MLAConfig, get_arch
from repro_torch.kernels import _build, _checks, ops, ref
from repro_torch.kernels import mla_attention as mk
from repro_torch.models import LM, params_from_jax
from repro_torch.models import mla as mla_mod
from repro_torch.serve import Request, SamplingParams, ServeEngine

ATOL = 1e-5
LOGIT_TOL = 1e-4
MAX_LEN = 32
# reduced deepseek-v2-lite's MLA: no q LoRA
DEEPSEEK_MLA = dict(kv_lora_rank=32, q_lora_rank=0, rope_head_dim=8, nope_head_dim=16,
                    v_head_dim=16)


@pytest.fixture(scope="module")
def jx():
    """(jax, jax.numpy, the JAX package's configs, models and serve modules)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro import serve as jserve
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.models import LM as JaxLM
    from repro.models import mla as jmla

    return dict(jax=jax, jnp=jnp, configs=jconfigs, serve=jserve, ops=jops, ref=jref,
                LM=JaxLM, mla=jmla)


def _pair(jx, variant):
    """(JAX cfg, JAX LM, JAX params, port cfg, port LM, port params) of
    reduced minicpm3-4b ("minicpm3") or of it with deepseek's MLA ("dense_wq")."""
    jcfg = jx["configs"].get_arch("minicpm3-4b").reduced()
    cfg = get_arch("minicpm3-4b").reduced()
    if variant == "dense_wq":
        jcfg = replace(jcfg, mla=jx["configs"].MLAConfig(**DEEPSEEK_MLA))
        cfg = replace(cfg, mla=MLAConfig(**DEEPSEEK_MLA))
    jm = jx["LM"](jcfg)
    jp = jm.init(jx["jax"].random.key(0))
    m = LM(cfg, device="cpu")
    p = params_from_jax(jx["jax"].tree.map(np.asarray, jp), device="cpu")
    return jcfg, jm, jp, cfg, m, p


@pytest.fixture(scope="module")
def minicpm3(jx):
    return _pair(jx, "minicpm3")


@pytest.fixture(scope="module", params=["minicpm3", "dense_wq"])
def pair(jx, request, minicpm3):
    return minicpm3 if request.param == "minicpm3" else _pair(jx, request.param)


def _close(got: torch.Tensor, want, atol=ATOL) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ----------------------------------------------------- config and params


def test_config_matches_the_jax_package(jx):
    for name in ("minicpm3-4b",):
        for red in (False, True):
            jcfg, cfg = jx["configs"].get_arch(name), get_arch(name)
            if red:
                jcfg, cfg = jcfg.reduced(), cfg.reduced()
            assert cfg.mla.__dict__ == jcfg.mla.__dict__
            for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_head", "d_ff",
                      "vocab_size", "tie_embeddings", "norm_eps", "rope_theta", "dtype"):
                assert getattr(cfg, f) == getattr(jcfg, f), (name, red, f)
            assert cfg.num_params() == jcfg.num_params()
    full = get_arch("minicpm3-4b")
    assert (full.n_layers, full.d_model, full.n_heads, full.d_ff, full.vocab_size) == (
        62, 2560, 40, 6400, 73448)
    assert full.tie_embeddings and full.norm_eps == 1e-6


def test_params_cross_unchanged_and_init_matches_their_shapes(jx, pair):
    """params_from_jax carries wq_a, q_norm, wq_b (or wq), wkv_a, kv_norm,
    wkv_b and wo [L, H, v, d] as they are; LM.init builds the same tree."""
    _, _, jp, cfg, m, p = pair
    ja, ta = jp["blocks"]["attn"], p["blocks"]["attn"]
    names = ({"wq_a", "q_norm", "wq_b"} if cfg.mla.q_lora_rank else {"wq"}) | {
        "wkv_a", "kv_norm", "wkv_b", "wo"}
    assert set(ja) == set(ta) == names
    for k in names:
        np.testing.assert_array_equal(ta[k].numpy(), np.asarray(ja[k]))
    assert ta["wo"].shape == (cfg.n_layers, cfg.n_heads, cfg.mla.v_head_dim, cfg.d_model)
    own = m.init(torch.Generator().manual_seed(0))
    shapes = jx["jax"].tree.map(lambda a: tuple(a.shape), jp)
    assert jx["jax"].tree.map(lambda t: tuple(t.shape), own) == shapes


# ------------------------------------------------- the plain attention


@pytest.mark.parametrize("pack_slots", [None, (3, 0, 2)])
def test_plain_mla_attention_vs_the_jax_kernel_and_ref(jx, pack_slots):
    jnp = jx["jnp"]
    rng = np.random.default_rng(5)
    b, s_max, h, r, rope = 4, 32, 4, 32, 8
    ckv, krope = _np(rng, b, s_max, r), _np(rng, b, s_max, rope)
    # local slots: a chunk of 6 at 10-15, singletons at 0, 31 and 20, one
    # padding token at S_max, a chunk of 2 at 3-4
    local = np.asarray([0] * 6 + [1, 2, 1, 2, 1, 1], np.int32)
    pos = np.asarray(list(range(10, 16)) + [0, 31, s_max, 20, 3, 4], np.int32)
    t = len(pos)
    q_eff, q_rope = _np(rng, t, h, r), _np(rng, t, h, rope)
    scale = 24**-0.5
    ps = np.asarray(pack_slots if pack_slots else range(b), np.int32)
    live = pos < s_max
    # JAX: the gathered rows at local slots; the port: the full cache at global ones
    jargs = (jnp.asarray(q_eff), jnp.asarray(q_rope), jnp.asarray(ckv[ps]),
             jnp.asarray(krope[ps]), jnp.asarray(local), jnp.asarray(pos))
    kern = jx["ops"].mla_ragged_attention(*jargs, scale=scale, mode="interpret")
    jref = jx["ref"].mla_ragged_attention(*jargs, scale=scale)
    got = ref.mla_ragged_attention(
        torch.from_numpy(q_eff), torch.from_numpy(q_rope), torch.from_numpy(ckv),
        torch.from_numpy(krope), torch.from_numpy(ps[local]), torch.from_numpy(pos),
        scale=scale)
    assert got.shape == (t, h, r)
    _close(got[live], np.asarray(kern)[live])
    _close(got[live], np.asarray(jref)[live])
    # the op routes CPU tensors to the plain version
    via_ops = ops.mla_ragged_attention(
        torch.from_numpy(q_eff), torch.from_numpy(q_rope), torch.from_numpy(ckv),
        torch.from_numpy(krope), torch.from_numpy(ps[local]), torch.from_numpy(pos),
        scale=scale)
    assert torch.equal(via_ops, got)


# -------------------------------------------------- the MLA functions


def _layer0(jx, jp, p):
    return (jx["jax"].tree.map(lambda a: a[0], jp["blocks"]["attn"]),
            {k: v[0] for k, v in p["blocks"]["attn"].items()})


def test_mla_apply_with_kv(jx, pair):
    jcfg, _, jp, cfg, _, p = pair
    jl, tl = _layer0(jx, jp, p)
    x = _np(np.random.default_rng(1), 2, 9, cfg.d_model)
    jo, (jc, jk) = jx["mla"].mla_apply(jl, jcfg, jx["jnp"].asarray(x),
                                       jx["jnp"].arange(9, dtype=jx["jnp"].int32),
                                       return_kv=True)
    o, (c, k) = mla_mod.mla_apply(tl, cfg, torch.from_numpy(x),
                                  torch.arange(9, dtype=torch.int32), return_kv=True)
    _close(o, jo)
    _close(c, jc)
    _close(k, jk)


def test_mla_decode(jx, pair):
    jcfg, _, jp, cfg, _, p = pair
    jnp = jx["jnp"]
    jl, tl = _layer0(jx, jp, p)
    rng = np.random.default_rng(2)
    ckv, krope = _np(rng, 3, MAX_LEN, 32), _np(rng, 3, MAX_LEN, 8)
    x = _np(rng, 3, 1, cfg.d_model)
    cur = np.asarray([5, 0, MAX_LEN - 1], np.int32)
    jo, jc, jk = jx["mla"].mla_decode(jl, jcfg, jnp.asarray(x), jnp.asarray(ckv),
                                      jnp.asarray(krope), jnp.asarray(cur))
    c, k = torch.from_numpy(ckv.copy()), torch.from_numpy(krope.copy())
    o, c2, k2 = mla_mod.mla_decode(tl, cfg, torch.from_numpy(x), c, k, torch.from_numpy(cur))
    assert c2 is c and k2 is k  # updated in place
    _close(o, jo)
    _close(c, jc)
    _close(k, jk)


def test_mla_packed(jx, pair):
    """A chunk, singletons and a padding row over 2 of 3 slots through
    pack_slots; padding rows' outputs are never read (JAX attends the whole
    slot there, as the port's plain path does) and are held too."""
    jcfg, _, jp, cfg, _, p = pair
    jnp = jx["jnp"]
    jl, tl = _layer0(jx, jp, p)
    rng = np.random.default_rng(3)
    ckv, krope = _np(rng, 3, MAX_LEN, 32), _np(rng, 3, MAX_LEN, 8)
    local = np.asarray([0] * 5 + [1, 1, 0], np.int32)
    pos = np.asarray([4, 5, 6, 7, 8, 0, 1, MAX_LEN], np.int32)
    ps = np.asarray([2, 0], np.int32)
    x = _np(rng, len(pos), cfg.d_model)
    n0 = mla_mod.packed_calls
    jo, jc, jk = jx["mla"].mla_packed(jl, jcfg, jnp.asarray(x), jnp.asarray(ckv),
                                      jnp.asarray(krope), jnp.asarray(local), jnp.asarray(pos),
                                      pack_slots=jnp.asarray(ps))
    c, k = torch.from_numpy(ckv.copy()), torch.from_numpy(krope.copy())
    o, _, _ = mla_mod.mla_packed(tl, cfg, torch.from_numpy(x), c, k, torch.from_numpy(local),
                                 torch.from_numpy(pos), pack_slots=torch.from_numpy(ps))
    assert mla_mod.packed_calls == n0 + 1
    _close(o, jo)
    _close(c, jc)
    _close(k, jk)


# ---------------------------------------------------------- the model


def test_lm_logits(jx, minicpm3):
    """Prefill (3 prompts of 11), two decode steps at ragged lengths, then a
    pack of two chunks through pack_slots with padding and out_rows."""
    jnp = jx["jnp"]
    _, jm, jp, _, m, p = minicpm3
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 256, size=(3, 11)).astype(np.int32)
    jlog, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    log, cache = m.prefill(p, {"tokens": torch.from_numpy(toks)}, MAX_LEN)
    assert set(cache) == {"ckv", "krope"}
    _close(log, jlog, LOGIT_TOL)
    cur = np.asarray([11, 7, 0], np.int32)
    t1 = rng.integers(0, 256, size=(3, 1)).astype(np.int32)
    for _ in range(2):
        jlog, jcache = jm.decode_step(jp, jcache, {"tokens": jnp.asarray(t1)}, jnp.asarray(cur))
        log, cache = m.decode_step(p, cache, {"tokens": torch.from_numpy(t1)},
                                   torch.from_numpy(cur))
        _close(log, jlog, LOGIT_TOL)
        t1 = np.array(jnp.argmax(jlog, -1), np.int32)
        cur = cur + 1
    local = [0] * 6 + [1] * 5 + [0] * 5
    pos = list(range(4, 10)) + list(range(11, 16)) + [MAX_LEN] * 5
    args = (rng.integers(0, 256, size=len(local)).astype(np.int32),
            np.asarray(local, np.int32), np.asarray(pos, np.int32))
    out_rows, ps = np.asarray([5, 10, 12], np.int32), np.asarray([2, 0], np.int32)
    jlog, jcache = jm.packed_step(jp, jcache, *map(jnp.asarray, args),
                                  out_rows=jnp.asarray(out_rows), pack_slots=jnp.asarray(ps),
                                  max_len=MAX_LEN)
    log, cache = m.packed_step(p, cache, *map(torch.from_numpy, args),
                               out_rows=torch.from_numpy(out_rows),
                               pack_slots=torch.from_numpy(ps), max_len=MAX_LEN)
    _close(log, jlog, LOGIT_TOL)
    _close(cache["ckv"], jcache["ckv"], LOGIT_TOL)
    _close(cache["krope"], jcache["krope"], LOGIT_TOL)


# --------------------------------------------------------- the engine

# tests/test_serve.py's MLA traffic: 8 ragged prompts through 3 slots
PROMPT_LENS = (5, 23, 11, 31, 8, 17, 26, 3)


@pytest.mark.parametrize("budget", [None, 8])
def test_engine_streams_equal_the_jax_engine(jx, minicpm3, budget):
    """Greedy streams of 5-8 new tokens at the default budget (fused
    admissions below 64 tokens) and at a budget of 8 (chunked packs)."""
    _, jm, jp, _, m, p = minicpm3
    js = jx["serve"]
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 256, size=s).astype(np.int32) for s in PROMPT_LENS]
    kw = {} if budget is None else dict(prefill_budget=budget)
    jeng = js.ServeEngine(jm, jp, batch_slots=3, max_len=64, **kw)
    eng = ServeEngine(m, p, batch_slots=3, max_len=64, device="cpu", **kw)
    for i, pr in enumerate(prompts):
        new = 5 + i % 4
        jeng.submit(js.Request(rid=i, prompt=pr, params=js.SamplingParams(max_new=new)))
        eng.submit(Request(rid=i, prompt=pr, params=SamplingParams(max_new=new)))
    jeng.run()
    n0 = mla_mod.packed_calls
    stats = eng.run()
    want = {r.rid: r.generated for r in jeng.finished}
    assert {r.rid: r.generated for r in eng.finished} == want
    assert stats.total_requests == len(PROMPT_LENS)
    if budget is not None:  # every prompt above 8 tokens took packs
        assert mla_mod.packed_calls > n0
    # the latent leaves' bytes, as the JAX engine counts them
    assert eng.kv_bytes_resident() == jeng.kv_bytes_resident() == 2 * 3 * 64 * 40 * 4


def test_mla_refusals(jx, minicpm3):
    """The latent cache neither pages nor quantizes (ValueError, where the
    JAX package refuses too); int8 weights for MLA are not ported; an ssm or
    hybrid config without its SSMConfig, and a moe config without its
    MoEConfig, are refused."""
    _, jm, jp, cfg, m, p = minicpm3
    js = jx["serve"]
    for kw in (dict(kv_dtype="int8"), dict(kv_block_size=16), dict(kv_block_size=16,
                                                                   prefix_cache=True)):
        with pytest.raises(ValueError, match="positional KV"):
            ServeEngine(m, p, batch_slots=2, max_len=64, device="cpu", **kw)
        with pytest.raises(ValueError):
            js.ServeEngine(jm, jp, batch_slots=2, max_len=64, **kw)
    with pytest.raises(ValueError):
        ServeEngine(m, p, batch_slots=2, max_len=64, device="cpu", prefix_cache=True)
    with pytest.raises(NotImplementedError, match="MLA"):
        ServeEngine(m, p, batch_slots=2, max_len=64, device="cpu", weight_dtype="int8")
    with pytest.raises(ValueError, match="quantize"):
        m.init_cache(2, 16, kv_dtype=torch.int8)
    with pytest.raises(ValueError, match="page"):
        m.init_kv_pool(4, 16)
    cache = m.init_cache(2, 16)
    with pytest.raises(ValueError, match="paged"):
        m.decode_step(p, cache, {"tokens": torch.zeros(2, 1, dtype=torch.int32)},
                      torch.zeros(2, dtype=torch.int32),
                      block_tables=torch.zeros(2, 1, dtype=torch.int32))
    assert (m.supports_packed, m.has_positional_kv, m.family_tag) == (True, False, "dense+mla")
    dense = LM(get_arch("codeqwen1.5-7b").reduced(), device="cpu")
    assert (dense.supports_packed, dense.has_positional_kv, dense.family_tag) == (
        True, True, "dense")
    for family in ("ssm", "hybrid"):
        with pytest.raises(ValueError, match="SSMConfig"):
            LM(replace(cfg, family=family), device="cpu")
    # the moe family is ported: a moe config without its MoEConfig is refused,
    # where the JAX package fails building its params
    with pytest.raises(ValueError, match="MoEConfig"):
        LM(replace(cfg, family="moe"), device="cpu")
    with pytest.raises(AttributeError):
        jx["LM"](replace(minicpm3[0], family="moe")).init(jx["jax"].random.key(0))


# ------------------------------------------------------ kernel wrapper


@pytest.mark.parametrize("h,r,dtype,want", [
    # (rows a block, blocks, span, splits) of phase 2's 64-token pack over
    # 1024 positions on 132 SMs: bf16 tiles of 64 (token, head) rows, f32
    # blocks of a token's chunk of 16 heads
    (40, 256, torch.bfloat16, (64, 40, 256, 4)), (16, 512, torch.bfloat16, (64, 16, 256, 4)),
    (4, 32, torch.float32, (16, 64, 1024, 1)), (64, 256, torch.bfloat16, (64, 64, 256, 4)),
    (64, 512, torch.bfloat16, (64, 64, 256, 4)), (64, 32, torch.bfloat16, (64, 64, 256, 4)),
    (50, 256, torch.bfloat16, (64, 50, 256, 4)), (40, 256, torch.float32, (16, 192, 1024, 1)),
])
def test_plan_chunks_the_heads(h, r, dtype, want):
    rows, blocks, span, splits = mk.plan(64, h, 1024, dtype, 132)
    assert (rows, blocks, span, splits) == want
    if dtype == torch.bfloat16:  # the heads of every token, flattened into whole tiles
        assert (blocks - 1) * rows < 64 * h <= blocks * rows
    else:  # each token's heads in chunks of 16
        assert blocks == 64 * -(-h // rows)


@pytest.mark.parametrize("r,rope,h", [(64, 8, 4), (256, 64, 40), (576, 0, 16), (32, 8, 65),
                                      (512, 64, 0)])
def test_wrapper_refuses_outside_the_domain_before_the_c_call(monkeypatch, r, rope, h):
    monkeypatch.setattr(_checks, "cuda_operands", lambda *a: None)

    def load():
        raise AssertionError("the wrapper reached the C library")

    monkeypatch.setattr(_build, "load", load)
    i32 = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="kv_lora_rank"):
        mk.mla_attention(torch.zeros(2, h, r, dtype=torch.bfloat16),
                         torch.zeros(2, h, rope, dtype=torch.bfloat16),
                         torch.zeros(1, 8, r, dtype=torch.bfloat16),
                         torch.zeros(1, 8, rope, dtype=torch.bfloat16), i32, i32, scale=1.0)


def test_every_mla_config_is_in_the_kernel_domain():
    for name in ("minicpm3-4b",):
        for cfg in (get_arch(name), get_arch(name).reduced()):
            _checks.mla_domain(cfg.mla.kv_lora_rank, cfg.mla.rope_head_dim, cfg.n_heads)
    _checks.mla_domain(512, 64, 16)  # deepseek-v2-lite's widths


# ----------------------------------------------------------------- CUDA


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("r,rope,h,dtype", [
    (256, 32, 40, torch.bfloat16), (512, 64, 16, torch.bfloat16), (32, 8, 4, torch.float32),
    (32, 8, 4, torch.bfloat16), (256, 32, 64, torch.bfloat16), (512, 64, 16, torch.float32),
])
def test_cuda_mla_attention_vs_plain(r, rope, h, dtype):
    """A pack of a chunk at 600-639, one at 0-15 of another slot, singletons
    and padding tokens over 3 slots x 700 positions; padding rows zero."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(r + h)
    b, s = 3, 700
    ckv = torch.randn(b, s, r, generator=gen, device=dev).to(dtype)
    krope = torch.randn(b, s, rope, generator=gen, device=dev).to(dtype)
    slots = [2] * 40 + [0] * 16 + [1, 0, 2] + [0] * 5
    pos = list(range(600, 640)) + list(range(16)) + [699, 300, 5] + [s] * 5
    ts = torch.tensor(slots, dtype=torch.int32, device=dev)
    tp = torch.tensor(pos, dtype=torch.int32, device=dev)
    q_eff = torch.randn(len(pos), h, r, generator=gen, device=dev).to(dtype)
    q_rope = torch.randn(len(pos), h, rope, generator=gen, device=dev).to(dtype)
    scale = (r // 4 + rope) ** -0.5
    n0 = mk.launches
    got = mk.mla_attention(q_eff, q_rope, ckv, krope, ts, tp, scale=scale)
    assert mk.launches == n0 + 1
    want = ref.mla_ragged_attention(q_eff, q_rope, ckv, krope, ts, tp, scale=scale)
    torch.cuda.synchronize()
    real = tp < s
    assert not got[~real].any(), "padding rows must be zero"
    err = (got[real].float() - want[real].float()).abs().max().item()
    assert err <= (1e-4 if dtype == torch.float32 else 2e-2), err


# chip_smoke.py's serving pack: 40 prompt tokens of slot 1, 16 of slot 3 at
# 600-615 and 8 padding tokens riding slot 1, over 4 slots of 1024 positions
SERVE_SLOT = [1] * 40 + [3] * 16 + [1] * 8
SERVE_POS = list(range(0, 40)) + list(range(600, 616)) + [1024] * 8


def _serve_case(dev, r, rope, h, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    bf16 = torch.bfloat16
    ckv = torch.randn(4, 1024, r, generator=gen, device=dev).to(bf16)
    krope = torch.randn(4, 1024, rope, generator=gen, device=dev).to(bf16)
    q_eff = torch.randn(64, h, r, generator=gen, device=dev).to(bf16)
    q_rope = torch.randn(64, h, rope, generator=gen, device=dev).to(bf16)
    ts = torch.tensor(SERVE_SLOT, dtype=torch.int32, device=dev)
    tp = torch.tensor(SERVE_POS, dtype=torch.int32, device=dev)
    return q_eff, q_rope, ckv, krope, ts, tp


@pytest.mark.cuda
@pytest.mark.parametrize("r,rope,h", [(256, 32, 40), (512, 64, 16), (32, 8, 4)])
@pytest.mark.parametrize("splits", [None, 1, 2, 4])
def test_cuda_mla_forced_spans(r, rope, h, splits):
    """The serving pack at the kernel's own split count and at forced ones
    (spans of 1024, 512 and 256 positions), all on the wgmma body."""
    dev = _cuda()
    args = _serve_case(dev, r, rope, h, seed=r + h)
    scale = (r // 4 + rope) ** -0.5
    n0 = mk.launches_wgmma
    got = mk.mla_attention(*args, scale=scale, splits=splits)
    assert mk.launches_wgmma == n0 + 1
    want = ref.mla_ragged_attention(*args, scale=scale)
    torch.cuda.synchronize()
    real = args[5] < 1024
    assert not got[~real].any(), "padding rows must be zero"
    assert (got[real].float() - want[real].float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
def test_cuda_graph_replays_mla_bitwise():
    """The serving pack at minicpm3's and deepseek's widths, at the kernel's
    own split and at one, captured in one CUDA graph and replayed: bitwise
    the eager results, twice."""
    dev = _cuda()
    a = _serve_case(dev, 256, 32, 40, seed=1)
    b = _serve_case(dev, 512, 64, 16, seed=2)

    def step():
        return (mk.mla_attention(*a, scale=0.1), mk.mla_attention(*a, scale=0.1, splits=1),
                mk.mla_attention(*b, scale=0.07))

    eager = step()
    torch.cuda.synchronize()
    n0 = mk.launches_wgmma
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    assert mk.launches_wgmma == n0 + 3
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(outs, eager):
            assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_mla_offset_views():
    """Slices of a larger cache and query batch (past their first slot and
    token: contiguous, 16-byte aligned) are taken and match the plain
    version; a view one element off is refused before the C call."""
    dev = _cuda()
    q_eff, q_rope, ckv, krope, _, _ = _serve_case(dev, 256, 32, 40, seed=3)
    q_eff, q_rope, ckv, krope = q_eff[1:], q_rope[1:], ckv[1:], krope[1:]
    assert ckv.storage_offset() > 0 and q_eff.storage_offset() > 0
    ts = torch.tensor([0, 2, 1] * 21, dtype=torch.int32, device=dev)
    tp = torch.tensor([1023, 0, 517] * 20 + [1024, 5, 300], dtype=torch.int32, device=dev)
    got = mk.mla_attention(q_eff, q_rope, ckv, krope, ts, tp, scale=0.1)
    want = ref.mla_ragged_attention(q_eff, q_rope, ckv, krope, ts, tp, scale=0.1)
    torch.cuda.synchronize()
    real = tp < 1024
    assert not got[~real].any()
    assert (got[real].float() - want[real].float()).abs().max().item() <= 2e-2
    buf = torch.zeros(krope.numel() + 8, dtype=krope.dtype, device=dev)
    shifted = buf[1:1 + krope.numel()].view(krope.shape)  # contiguous, 2 bytes off
    shifted.copy_(krope)
    with pytest.raises(ValueError, match="aligned"):
        mk.mla_attention(q_eff, q_rope, ckv, shifted, ts, tp, scale=0.1)


@pytest.mark.cuda
def test_cuda_mla_refuses_outside_the_domain():
    dev = _cuda()
    z = dict(dtype=torch.bfloat16, device=dev)
    i32 = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="kv_lora_rank"):
        mk.mla_attention(torch.zeros(1, 4, 128, **z), torch.zeros(1, 4, 16, **z),
                         torch.zeros(1, 8, 128, **z), torch.zeros(1, 8, 16, **z), i32, i32,
                         scale=1.0)
