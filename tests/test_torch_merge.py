"""Tensor-parallel merge serving over lanes against the JAX package: a merged
``LM(cfg, mesh_info=serving_mesh_info(lanes))`` behind a ``ShardedBackend``
(heads, MLP width and vocabulary split over the lanes, the partial sums met
on the controller lane), through ``ServeCluster(mode="merge")`` and the
``repro_torch.launch.serve`` launcher. The lanes are ``"cpu"`` entries: each a
lane of its own, the plain PyTorch path of every kernel.

* streams — reduced codeqwen1.5-7b (MHA, 4 heads of 16, f32) over 2 and 4
  lanes serves greedy streams equal to the JAX ``ServeEngine``'s (the 8
  prompts of the JAX package's two-device cluster test, 3 slots, max_len
  64): whole admissions, ``prefill_budget=5`` chunks, the legacy tier and
  a mid-stream MERGE -> SPLIT switch; over 2 lanes, paged KV with prefix
  reuse and seeded top-k / top-p sampling;
* logits — a 2-layer, d_model 256, f32 config whose matrices are placed
  sharded (every one but variant (b)'s wk / wv, 32,768 elements each, which
  stay whole: the lanes take their heads from the replicated leaf), in two
  variants: (a) 4 heads = 4 KV heads x 64, (b) 8 heads over 2 KV heads x 32
  with qk_norm; ``prefill``, ``decode_step`` and ``packed_step`` over 2
  lanes against JAX ``LM``'s within 1e-5 of the largest logit, and each
  lane's leaves the blocks its placement names (``wo`` by heads, not JAX's
  head_dim);
* refusals — MLA, MoE, ssm, hybrid, int8 / fp8 KV, int8 weights,
  speculation and KV heads that do not divide: ``NotImplementedError``
  naming ROADMAP, before a queued request is drained;
* the launcher at ``--reduced --devices cpu,cpu`` in each of single, split,
  merge and auto: the same tokens in every mode, its lines in the JAX
  launcher's format.

Greedy and seeded streams are exact: partial sums change the last bits of
a logit, never its argmax or a seeded draw here.
"""

import re
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core.modes import Mode
from repro_torch.dist import collectives
from repro_torch.dist.sharding import (
    MODEL_AXIS,
    P,
    ShardedTensor,
    gather,
    keystr,
    param_shardings,
    serve_param_shardings,
    serving_mesh_info,
    tree_map_with_path,
)
from repro_torch.models import LM, params_from_jax
from repro_torch.serve import (
    DeviceBackend,
    Request,
    SamplingParams,
    ServeCluster,
    ServeEngine,
    ShardedBackend,
)

LANES2 = ["cpu", "cpu"]
LANES4 = ["cpu"] * 4
ENGINE = dict(batch_slots=3, max_len=64)
LENS = (5, 23, 11, 31, 8, 17, 26, 3)
REL_TOL = 1e-5
MAX_LEN = 32


def _jax_pair(cfg_name: str, key: int = 0, **over):
    """(JAX LM, JAX params, port LM config, port params on the CPU) of the
    reduced ``cfg_name`` with ``over`` replaced in both configs."""
    import jax

    from repro.configs import get_arch as jax_get_arch
    from repro.models import LM as JaxLM

    jm = JaxLM(replace(jax_get_arch(cfg_name).reduced(), **over))
    jp = jm.init(jax.random.key(key))
    cfg = replace(get_arch(cfg_name).reduced(), **over)
    return jm, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _specs(vocab: int) -> dict:
    """rid -> (prompt, SamplingParams kwargs): the greedy scenario (0-7),
    seeded top-k / top-p requests (10-13), and prompts sharing a 16-token
    prefix (20-23) for the paged pool."""
    rng = np.random.default_rng(11)
    out = {i: (rng.integers(0, vocab, size=s), dict(max_new=6)) for i, s in enumerate(LENS)}
    rng = np.random.default_rng(12)
    kinds = [dict(temperature=0.9, top_p=0.85, seed=11), dict(temperature=1.1, top_k=6, seed=22),
             dict(temperature=1.0, top_k=9, top_p=0.9, seed=33), dict()]
    for i, s in enumerate((7, 19, 12, 4)):
        out[10 + i] = (rng.integers(0, vocab, size=s), dict(max_new=8, **kinds[i]))
    shared = rng.integers(0, vocab, size=16)
    for i, s in enumerate((3, 9, 1, 14)):
        out[20 + i] = (np.concatenate([shared, rng.integers(0, vocab, size=s)]),
                       dict(max_new=7, **(dict(temperature=0.8, seed=40 + i) if i % 2 else {})))
    return {rid: (pr.astype(np.int32), kw) for rid, (pr, kw) in out.items()}


GREEDY, SAMPLED, SHARED = range(0, 8), range(10, 14), range(20, 24)


@pytest.fixture(scope="module")
def world():
    """(port config, port params, specs, JAX streams of every request)."""
    from repro.serve import Request as JaxRequest
    from repro.serve import SamplingParams as JaxSamplingParams
    from repro.serve import ServeEngine as JaxServeEngine

    jm, jp, cfg, p = _jax_pair("codeqwen1.5-7b")
    specs = _specs(cfg.vocab_size)
    ref = {}
    for rids, kw in ((list(GREEDY) + list(SAMPLED), {}),
                     (SHARED, dict(kv_block_size=8, prefix_cache=True))):
        eng = JaxServeEngine(jm, jp, **ENGINE, **kw)
        for rid in rids:
            prompt, params = specs[rid]
            eng.submit(JaxRequest(rid=rid, prompt=prompt, params=JaxSamplingParams(**params)))
        eng.run()
        ref.update({r.rid: r.generated for r in eng.finished})
    return cfg, p, specs, ref


def _reqs(world, rids):
    specs = world[2]
    return [Request(rid=rid, prompt=specs[rid][0], params=SamplingParams(**specs[rid][1]))
            for rid in rids]


def _served(cl) -> dict:
    return {r.rid: r.generated for r in cl.finished}


def _merged(world, devices, **kw) -> ServeCluster:
    cfg, p = world[0], world[1]
    cl = ServeCluster(LM(cfg, device="cpu"), p, mode=Mode.MERGE, devices=devices,
                      **{**ENGINE, **kw})
    back = cl.engines[0].backend
    assert isinstance(back, ShardedBackend) and back.mesh_info.model_size == len(devices)
    assert back.describe() == f"sharded:model={len(devices)},devices={len(devices)}"
    return cl


# ------------------------------------------------------------------ streams


@pytest.mark.parametrize("devices", [LANES2, LANES4], ids=["2 lanes", "4 lanes"])
@pytest.mark.parametrize("kw", [{}, dict(prefill_budget=5), dict(unified=False)],
                         ids=["whole", "budget 5", "legacy tier"])
def test_merged_greedy_streams_equal_jax(world, devices, kw):
    cl = _merged(world, devices, **kw)
    eng = cl.engines[0]
    assert eng.model.merged and all(isinstance(t, ShardedTensor) for t in eng.cache.values())
    assert eng.kv_bytes_resident() == sum(t.numel() * t.element_size()
                                          for t in eng.cache.values())
    for r in _reqs(world, GREEDY):
        cl.submit(r)
    stats = cl.run()
    assert _served(cl) == {rid: world[3][rid] for rid in GREEDY}
    assert stats.mode == "merge" and stats.total_requests == len(GREEDY)


@pytest.mark.parametrize("devices", [LANES2, LANES4], ids=["2 lanes", "4 lanes"])
def test_mid_stream_merge_to_split(world, devices):
    """MERGE -> SPLIT mid-stream (drain, re-home, resume), then the warm
    switch back: every stream equals JAX's."""
    cl = _merged(world, devices)
    arrivals = [(i * 0.002, r) for i, r in enumerate(_reqs(world, GREEDY))]
    stats = cl.run(arrivals=arrivals, reconfigure_schedule=[(0.006, Mode.SPLIT)])
    assert _served(cl) == {rid: world[3][rid] for rid in GREEDY}
    assert len(stats.reconfigures) == 1 and stats.mode == "merge->split"
    rep = cl.reconfigure(Mode.MERGE)
    assert rep.cached and rep.bytes_moved == 0
    cl.finished.clear()
    for r in _reqs(world, GREEDY):
        cl.submit(r)
    cl.run()
    assert _served(cl) == {rid: world[3][rid] for rid in GREEDY}


def test_merged_paged_prefix_and_seeded_streams(world):
    cl = _merged(world, LANES2, kv_block_size=8, prefix_cache=True)
    eng = cl.engines[0]
    assert isinstance(eng.cache["k"], ShardedTensor) and eng.cache["k"].shape[1] == \
        eng.num_blocks + 1
    for r in _reqs(world, SHARED):
        cl.submit(r)
    cl.run()
    assert _served(cl) == {rid: world[3][rid] for rid in SHARED}
    assert eng.prefix.stats().hits > 0
    cl = _merged(world, LANES2)
    for r in _reqs(world, SAMPLED):
        cl.submit(r)
    cl.run()
    assert _served(cl) == {rid: world[3][rid] for rid in SAMPLED}


def test_merge_bytes_placed_count_the_sharded_leaves(world):
    cfg, p = world[0], world[1]
    cl = ServeCluster(LM(cfg, device="cpu"), p, devices=LANES2, **ENGINE)
    rep = cl.reconfigure(Mode.MERGE)
    eng = cl.engines[0]
    params = sum(t.numel() * t.element_size()
                 for t in _leaves(eng.params) if isinstance(t, ShardedTensor))
    cache = sum(t.numel() * t.element_size() for t in eng.cache.values())
    assert not rep.cached and rep.bytes_moved == params + cache > 0
    assert params == sum(t.numel() * t.element_size() for t in _leaves(p))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ------------------------------------------------------------------- logits


WIDE = {
    "a: 4 heads = 4 KV x 64": dict(n_heads=4, n_kv_heads=4, d_head=64),
    "b: 8 heads / 2 KV x 32, qk_norm": dict(n_heads=8, n_kv_heads=2, d_head=32, qk_norm=True),
}


@pytest.fixture(scope="module", params=list(WIDE))
def wide(request):
    over = dict(n_layers=2, d_model=256, d_ff=512, vocab_size=512, **WIDE[request.param])
    jm, jp, cfg, p = _jax_pair("codeqwen1.5-7b", key=3, **over)
    info = serving_mesh_info(LANES2)
    m = LM(cfg, mesh_info=info)
    sp = ShardedBackend(info).put_params(m, p)
    return jm, jp, m, p, sp


def _rel_close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= REL_TOL * np.abs(want).max(), (err, np.abs(want).max())


def _toks(rng, *shape):
    return rng.integers(0, 512, size=shape).astype(np.int32)


def test_wide_placement_per_lane(wide):
    """Every leaf is placed as ``serve_param_shardings`` names — the JAX
    rules' spec, except wo by heads — and each lane holds that block of the
    global leaf."""
    _, _, m, p, sp = wide
    info = m.mesh_info
    jax_like = param_shardings(p, info)
    want = {
        "wq": P(None, None, MODEL_AXIS, None), "wo": P(None, MODEL_AXIS, None, None),
        "w_in": P(None, None, MODEL_AXIS), "w_gate": P(None, None, MODEL_AXIS),
        "w_out": P(None, MODEL_AXIS, None), "tok": P(MODEL_AXIS, None),
        "head": P(None, MODEL_AXIS),
        "wk": P(None, None, MODEL_AXIS, None) if m.cfg.n_kv_heads == 4 else P(),
    }
    want["wv"] = want["wk"]
    seen = []

    def check(path, leaf):
        name = path[-1]
        spec = leaf.sharding.spec
        assert spec == want.get(name, P()), (keystr(path), spec)
        base = jax_like
        for k in path:
            base = base[k]
        if name == "wo":  # JAX's attention rule splits wo's head_dim
            assert base.spec == P(None, None, MODEL_AXIS, None)
        else:
            assert base.spec == spec, keystr(path)
        glob = p
        for k in path:
            glob = glob[k]
        for t, block in zip(leaf.shards, leaf.sharding.blocks(leaf.shape)):
            assert torch.equal(t, glob[tuple(slice(a, b) for a, b in block)])
        seen.append(name)

    tree_map_with_path(check, sp)
    assert {"wq", "wo", "w_in", "tok", "head"} <= set(seen)
    assert serve_param_shardings(p, info)["blocks"]["attn"]["wo"].spec == want["wo"]


def test_wide_prefill_decode_packed_logits(wide):
    import jax.numpy as jnp

    jm, jp, m, _, sp = wide
    rng = np.random.default_rng(0)
    toks = _toks(rng, 3, 11)
    jlog, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    log, cache = m.prefill(sp, {"tokens": torch.from_numpy(toks)}, MAX_LEN)
    _rel_close(log, jlog)
    assert all(isinstance(t, ShardedTensor) and t.sharding.spec == P(None, None, None,
                                                                      MODEL_AXIS, None)
               for t in cache.values())
    cur = np.asarray([11, 7, 0], np.int32)
    step = _toks(rng, 3, 1)
    for _ in range(2):
        jlog, jcache = jm.decode_step(jp, jcache, {"tokens": jnp.asarray(step)},
                                      jnp.asarray(cur))
        log, cache = m.decode_step(sp, cache, {"tokens": torch.from_numpy(step)},
                                   torch.from_numpy(cur))
        _rel_close(log, jlog)
        step = np.asarray(jnp.argmax(jlog, -1), np.int32)
        cur = cur + 1
    local = [0] * 6 + [1] * 5 + [0] * 5
    pos = list(range(4, 10)) + list(range(11, 16)) + [MAX_LEN] * 5
    args = (_toks(rng, len(local)), np.asarray(local, np.int32), np.asarray(pos, np.int32))
    pack_slots, out_rows = np.asarray([2, 0], np.int32), np.asarray([5, 10, 12], np.int32)
    jlog, jcache = jm.packed_step(jp, jcache, *map(jnp.asarray, args),
                                  out_rows=jnp.asarray(out_rows),
                                  pack_slots=jnp.asarray(pack_slots), max_len=MAX_LEN)
    log, cache = m.packed_step(sp, cache, *map(torch.from_numpy, args),
                               out_rows=torch.from_numpy(out_rows),
                               pack_slots=torch.from_numpy(pack_slots), max_len=MAX_LEN)
    _rel_close(log, jlog)
    for name in ("k", "v"):
        np.testing.assert_allclose(gather(cache[name]).numpy(), np.asarray(jcache[name]),
                                   atol=1e-5, rtol=0)


def test_lane_collectives_order_and_bits():
    """lane_reduce adds in lane order; the all-forms hand every lane the same
    tensor (one device: no copy); gather concatenates in lane order."""
    lanes = serving_mesh_info(LANES4).mesh.lanes
    parts = [torch.full((2, 3), float(10 ** j)) for j in range(4)]
    out = collectives.lane_all_reduce(parts, lanes)
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert all(o is out[0] for o in out) and torch.equal(out[0], want)
    g = collectives.lane_all_gather(parts, lanes, dim=-1)
    assert all(o is g[0] for o in g) and torch.equal(g[0], torch.cat(parts, -1))
    assert torch.equal(collectives.lane_gather(parts, lanes, 0), torch.cat(parts, 0))
    assert all(t is parts[0] for t in collectives.lane_broadcast(parts[0], lanes))


# ----------------------------------------------------------------- refusals


REFUSED_MODELS = ["minicpm3-4b", "llama4-scout-17b-a16e", "falcon-mamba-7b", "zamba2-2.7b",
                  "qwen3-32b"]  # MLA, MoE, ssm, hybrid, 1 KV head over 2 lanes
REFUSED_OPTIONS = [dict(kv_dtype="int8"), dict(kv_dtype="fp8"), dict(weight_dtype="int8"),
                   dict(speculate="ngram")]


@pytest.mark.parametrize("name", REFUSED_MODELS)
def test_merge_refuses_model(world, name):
    cfg = get_arch(name).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LM(cfg, mesh_info=serving_mesh_info(LANES2))
    m = LM(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    kw = dict(batch_slots=2, max_len=32, unified=False if cfg.family == "hybrid" else None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServeCluster(m, p, mode=Mode.MERGE, devices=LANES2, **kw)
    _refused_before_drain(ServeCluster(m, p, devices=LANES2, **kw), cfg.vocab_size)
    one = ServeCluster(m, p, mode=Mode.MERGE, devices=["cpu"], **kw)  # one device: plain
    assert isinstance(one.engines[0].backend, DeviceBackend)


@pytest.mark.parametrize("kw", REFUSED_OPTIONS, ids=lambda kw: "=".join(map(str, *kw.items())))
def test_merge_refuses_option(world, kw):
    cfg, p = world[0], world[1]
    m = LM(cfg, mesh_info=serving_mesh_info(LANES2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServeEngine(m, p, **ENGINE, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServeCluster(LM(cfg, device="cpu"), p, mode="merge", devices=LANES2, **ENGINE, **kw)
    _refused_before_drain(ServeCluster(LM(cfg, device="cpu"), p, devices=LANES2,
                                       **ENGINE, **kw), cfg.vocab_size)


def _refused_before_drain(cl: ServeCluster, vocab: int) -> None:
    """A queued request survives the refused switch and is served split."""
    r = Request(rid=0, prompt=np.arange(5, dtype=np.int32) % vocab,
                params=SamplingParams(max_new=2))
    cl.submit(r)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cl.reconfigure(Mode.MERGE)
    assert cl.mode is Mode.SPLIT and sum(len(e.waiting) for e in cl.engines) == 1
    cl.run()
    assert r.finish_reason == "length" and len(r.generated) == 2


# ----------------------------------------------------------------- launcher


def _normalized(text: str) -> list[str]:
    """The printed lines with every number replaced by '#'."""
    return [re.sub(r"\d[\d,.]*", "#", line) for line in text.strip().splitlines()]


def test_launcher_modes_agree_in_jax_format(capsys, monkeypatch):
    from repro_torch.launch import serve as launch

    base = ["--arch", "codeqwen1.5-7b", "--reduced", "--devices", "cpu,cpu", "--requests",
            "8", "--max-new", "6", "--max-len", "64", "--stream"]
    streams, lines = {}, {}
    for mode in ("single", "split", "merge", "auto"):
        target = launch.main(base + ["--cluster-mode", mode])
        streams[mode] = {r.rid: r.generated for r in target.finished}
        lines[mode] = capsys.readouterr().out
        if mode == "merge":
            assert isinstance(target.engines[0].backend, ShardedBackend)
    assert len(streams["single"]) == 8
    assert all(s == streams["single"] for s in streams.values())
    assert lines["auto"].startswith("cluster-mode auto -> split (closed-loop run_controlled)")

    import repro.launch.serve as jax_launch

    monkeypatch.setattr(sys, "argv", ["serve"] + [a for a in base if "cpu" not in a
                                                  and a != "--devices"])
    jax_launch.main()
    jax_lines = _normalized(capsys.readouterr().out)
    assert _normalized(lines["single"]) == jax_lines
    split = _normalized(lines["split"])
    assert [ln.split(" ")[0] for ln in split] == [ln.split(" ")[0] for ln in jax_lines]
    assert "[ServeCluster(mode=merge, devices=2, replicas=1)]" in lines["merge"]
