"""Dispatch layer for the port's kernels, mirroring ``repro.kernels.ops``.

The device of the tensors decides, as ``ops._resolve`` decides by backend
in the JAX package, but with no mode that could pick the plain version on
the card: a CPU tensor runs the plain PyTorch version in :mod:`ref`, a CUDA
tensor runs the hand-written CUDA kernel, anything else raises, except that
the ops a model step calls trace their plain version on ``meta`` (the
production dry run, :mod:`repro_torch.launch.dryrun`). The
quantized store rides the same ops: ``k_scale``/``v_scale`` (f32, one per
(position, head) row) mark an int8/fp8 cache, widened inside the kernel or
the plain version, never as a dequantized cache copy. The paged ops take a
block-paged pool and its block tables. ``mla_ragged_attention`` is the
packed attention of multi-head latent attention over its latent cache.
``matmul_q8`` is the int8-weight product of
:func:`repro_torch.models.quant.qmatmul`.

The kernel API's tuned ops (``matmul``, ``flash_attention``, ``rmsnorm``,
``softmax``, and the paper's kernel suite ``axpy``, ``dotp``, ``fft`` and
``conv2d``) take their kernel's knobs from the autotuner
(:mod:`repro_torch.kernels.autotune`, backend ``"cuda"``) unless the caller
pins them; the resolved plan is memoised per static (op, shape, dtype) cell
and tuner generation, as in the JAX package. A CPU tensor never consults
the tuner. The serving ops (attention over the caches, ``matmul_q8``) keep
fixed plans. ``mode`` is not ported: the tensor's device decides.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import autotune
from repro_torch.kernels import axpy as _axpy_k
from repro_torch.kernels import conv2d as _conv2d_k
from repro_torch.kernels import decode_attention as _decode_k
from repro_torch.kernels import dotp as _dotp_k
from repro_torch.kernels import fft as _fft_k
from repro_torch.kernels import flash_attention as _flash_k
from repro_torch.kernels import matmul as _matmul_k
from repro_torch.kernels import mla_attention as _mla_k
from repro_torch.kernels import paged_attention as _paged_k
from repro_torch.kernels import ragged_attention as _ragged_k
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rmsnorm_k
from repro_torch.kernels import softmax as _softmax_k

BACKEND = "cuda"  # the tuner's backend of the port's kernels


@functools.lru_cache(maxsize=4096)
def _plan(op: str, shape: tuple[int, ...], dtype_name: str, gen: int,
          operands: tuple = ()) -> dict[str, int]:
    """Memoised plan for one static (op, shape, dtype) cell on backend
    ``"cuda"``. ``gen`` is the tuner generation — swapping tuners (tests)
    invalidates every memoised plan without touching this cache directly.
    ``operands``: shapes a sweep's measure needs beyond the key's (conv2d:
    w's); the cache key does not carry them, as in the JAX package. A
    cached config the kernel no longer has is a miss (``Autotuner.hit``)."""
    tuner = autotune.get_tuner()
    hit = tuner.hit(op, shape, dtype_name, BACKEND)
    if hit is not None:
        return dict(hit)
    # only build the measure closure (it allocates synthetic inputs of
    # the caller's shape) once we know the lookup missed and a sweep will run
    measure = (autotune.measure_for(op, shape, dtype_name, BACKEND, *operands)
               if tuner.sweep else None)
    return tuner.get(op, shape, dtype_name, BACKEND, measure=measure)


def _blocks(op: str, shape: tuple[int, ...], dtype, *operands) -> dict[str, int]:
    return _plan(op, tuple(shape), autotune.dtype_name(dtype), autotune.generation(),
                 tuple(tuple(o) for o in operands))


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x as [rows, last dim], contiguous."""
    return x.reshape(-1, x.shape[-1]).contiguous()


@functools.lru_cache(maxsize=64)
def _seq_ids(b: int, device: torch.device) -> torch.Tensor:
    """[0, b) int32 on ``device``: the table rows of a paged decode, built
    once per batch size instead of once per layer."""
    return torch.arange(b, dtype=torch.int32, device=device)


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel path for device {t.device}")


def _step_on_cuda(t: torch.Tensor) -> bool:
    """``_on_cuda`` for the ops a model step calls: on ``meta`` (the dry run's
    placeholder lanes) they trace their plain version."""
    return t.device.type != "meta" and _on_cuda(t)


def matmul(a, b, *, split_k: Optional[int] = None, block_m: Optional[int] = None,
           block_n: Optional[int] = None):
    """[M, K] @ [K, N] with f32 accumulation, in a's dtype (f32 or bf16; b
    of the same dtype). ``split_k`` pins the kernel's K splits (0: its own
    choice), ``block_m`` x ``block_n`` its wgmma tile (0 x 0: its own
    choice, else one of ``matmul.TILES``); the tuner's plan fills the gaps."""
    if not _on_cuda(a):
        return ref.matmul(a, b)
    knobs = {"split_k": split_k, "block_m": block_m, "block_n": block_n}
    if None in knobs.values():
        plan = _blocks("matmul", (a.shape[0], a.shape[1], b.shape[1]), a.dtype)
        knobs = {name: plan[name] if v is None else v for name, v in knobs.items()}
    return _matmul_k.matmul(a.contiguous(), b.contiguous(), **knobs)


def matmul_q8(a, b_q8, b_scale):
    """[M, K] @ int8 [K, N] times per-output-column f32 scales [N], f32
    accumulation, in a's dtype: the weight stays int8 in memory and is
    widened inside the kernel."""
    if _step_on_cuda(a):
        return _matmul_k.matmul_q8(a.contiguous(), b_q8.contiguous(), b_scale.contiguous())
    return ref.matmul_q8(a, b_q8, b_scale)


def flash_attention(q, k, v, *, causal: bool = True, block_q: Optional[int] = None,
                    block_k: Optional[int] = None):
    """q/k/v: [B, H, S, d] or [BH, S, d]; k/v may have another length than
    q (keys past it masked; causal is top-left aligned). ``block_q`` /
    ``block_k`` pin the kernel's tile (one of ``flash_attention.TILES`` of
    q's dtype); the tuner's plan fills the gaps."""
    squeeze = q.ndim == 3
    if squeeze:
        q, k, v = q[None], k[None], v[None]
    b, h, s, d = q.shape
    if not _on_cuda(q):
        out = ref.flash_attention(q, k, v, causal=causal)
        return out[0] if squeeze else out
    qf = q.reshape(b * h, s, d).contiguous()
    kf = k.reshape(b * h, k.shape[2], d).contiguous()
    vf = v.reshape(b * h, v.shape[2], d).contiguous()
    if block_q is None or block_k is None:
        cfg = _blocks("flash_attention", qf.shape, q.dtype)
        block_q = cfg["block_q"] if block_q is None else block_q
        block_k = cfg["block_k"] if block_k is None else block_k
    out = _flash_k.flash_attention(qf, kf, vf, causal=causal, block_q=block_q,
                                   block_k=block_k).reshape(b, h, s, d)
    return out[0] if squeeze else out


def rmsnorm(x, w, *, eps: float = 1e-6, block_rows: Optional[int] = None):
    """``x * rsqrt(mean(x^2) + eps) * w`` over the last dim of x (any leading
    dims), f32 math, in x's dtype. ``block_rows`` pins the kernel's rows per
    block; by default the tuner's plan."""
    if not _on_cuda(x):
        return ref.rmsnorm(x, w, eps)
    x2 = _rows(x)
    if block_rows is None:
        block_rows = _blocks("rmsnorm", x2.shape, x.dtype)["block_rows"]
    out = _rmsnorm_k.rmsnorm(x2, w.contiguous(), eps=eps, block_rows=block_rows)
    return out.reshape(x.shape)


def softmax(x, *, block_rows: Optional[int] = None):
    """Numerically stable softmax over the last dim of x (any leading dims),
    f32 math, in x's dtype. ``block_rows`` pins the kernel's rows per block;
    by default the tuner's plan."""
    if not _on_cuda(x):
        return ref.softmax(x)
    x2 = _rows(x)
    if block_rows is None:
        block_rows = _blocks("softmax", x2.shape, x.dtype)["block_rows"]
    return _softmax_k.softmax(x2, block_rows=block_rows).reshape(x.shape)


def axpy(alpha, x, y, *, block: Optional[int] = None):
    """``alpha * x + y`` over 1-D or 2-D x and y of one shape, f32 math, in
    x's dtype; alpha is rounded to x's dtype first, as the TPU kernel does
    (``ref.axpy``). ``block`` pins the kernel's elements per CUDA block (0:
    its own choice); by default the tuner's plan, keyed on the [R, C] view
    (a vector is [1, N]), as in the JAX package."""
    if not _on_cuda(x):
        return ref.axpy(alpha, x, y)
    x2 = x.reshape(1, -1) if x.ndim == 1 else x
    y2 = y.reshape(1, -1) if y.ndim == 1 else y
    if block is None:
        block = _blocks("axpy", x2.shape, x.dtype)["block"]
    out = _axpy_k.axpy(alpha, x2.contiguous(), y2.contiguous(), block=block)
    return out.reshape(x.shape)


def dotp(x, y, *, block: Optional[int] = None):
    """The f32 dot product of x and y (any shape, flattened) as a 0-d tensor.
    ``block`` pins the kernel's elements per partial sum (0: the wrapper's
    choice); by default the tuner's plan, keyed on [1, N]."""
    if not _on_cuda(x):
        return ref.dotp(x, y)
    x2 = x.reshape(1, -1).contiguous()
    y2 = y.reshape(1, -1).contiguous()
    if block is None:
        block = _blocks("dotp", x2.shape, x.dtype)["block"]
    return _dotp_k.dotp(x2, y2, block=block)


def fft(re, im, *, block_rows: Optional[int] = None):
    """Batched complex FFT over the last dim of planar (re, im) [..., N],
    N a power of two (on the card 2 to 2^30: up to 16,384 points a row in
    one block, longer rows through the four-step kernels), f32 math, in re's
    and im's dtype. ``block_rows`` pins the kernel's rows per CUDA block; by
    default the tuner's plan."""
    if not _on_cuda(re):
        return ref.fft(re, im)
    re2, im2 = _rows(re), _rows(im)
    if block_rows is None:
        block_rows = _blocks("fft", re2.shape, re.dtype)["block_rows"]
    ore, oim = _fft_k.fft(re2, im2, block_rows=block_rows)
    return ore.reshape(re.shape), oim.reshape(im.shape)


def conv2d(x, w, *, block_h: Optional[int] = None):
    """NHWC x HWIO VALID convolution, stride 1, f32 sums, in x's dtype (x
    and w each f32 or bf16, both widened to f32).
    ``block_h`` pins the output rows of the kernel's pixel patch (0: its own
    choice); by default the tuner's plan, keyed on x's shape as in the JAX
    package (a sweep measures at w's shape too)."""
    if not _on_cuda(x):
        return ref.conv2d(x, w)
    if block_h is None:
        block_h = _blocks("conv2d", x.shape, x.dtype, w.shape)["block_h"]
    return _conv2d_k.conv2d(x.contiguous(), w.contiguous(), block_h=block_h)


def gqa_flash_attention(q, k, v, *, causal: bool = True):
    """GQA-native attention: q [B, H, S, d], k/v [B, KV, S, d], H % KV == 0.
    K/V are never expanded to H heads; on the card a KV head's group is
    packed into the kernel's query tile. Returns [B, H, S, d]."""
    b, h, sq, d = q.shape
    kvh = k.shape[1]
    if h % kvh:
        raise ValueError(f"heads {h} not a multiple of kv heads {kvh}")
    qg = q.reshape(b * kvh, h // kvh, sq, d)
    kf = k.reshape(b * kvh, k.shape[2], d)
    vf = v.reshape(b * kvh, v.shape[2], d)
    if _step_on_cuda(q):
        out = _flash_k.gqa_flash_attention(
            qg.contiguous(), kf.contiguous(), vf.contiguous(), causal=causal
        )
    else:
        out = ref.gqa_flash_attention(qg, kf, vf, causal=causal)
    return out.reshape(b, h, sq, d)


def decode_attention(q, k, v, cur_len, *, window: int = 0, k_scale=None, v_scale=None):
    """Batched single-token decode attention against the KV cache.
    q: [B, H, d]; k/v: [B, S_max, KV, d]; cur_len: [B] int32 tokens already
    cached per slot; ``k_scale``/``v_scale`` [B, S_max, KV] f32 for a
    quantized store. Returns [B, H, d]."""
    b, h, d = q.shape
    kvh = k.shape[2]
    if h % kvh:
        raise ValueError(f"heads {h} not a multiple of kv heads {kvh}")
    qg = q.reshape(b, kvh, h // kvh, d)
    if _step_on_cuda(q):
        out = _decode_k.decode_attention(
            qg.contiguous(), k, v, cur_len, window=window, k_scale=k_scale, v_scale=v_scale
        )
    else:
        out = ref.decode_attention(
            qg, k, v, cur_len, window=window, k_scale=k_scale, v_scale=v_scale
        )
    return out.reshape(b, h, d)


def ragged_attention(
    q, k, v, tok_slot, tok_pos, *, window: int = 0, valid: Optional[torch.Tensor] = None,
    k_scale=None, v_scale=None,
):
    """Packed variable-length attention: q [T, H, d] against k/v
    [B, S_max, KV, d], the tokens' K/V already scattered at (tok_slot,
    tok_pos) ([T] int32). ``valid`` optionally passes a precomputed
    ``ref.ragged_valid_mask`` to the plain version; the kernel derives its
    masks itself. ``k_scale``/``v_scale`` [B, S_max, KV] f32 for a quantized
    store. Returns [T, H, d]."""
    t, h, d = q.shape
    kvh = k.shape[2]
    if h % kvh:
        raise ValueError(f"heads {h} not a multiple of kv heads {kvh}")
    qg = q.reshape(t, kvh, h // kvh, d)
    if _step_on_cuda(q):
        out = _ragged_k.ragged_attention(
            qg.contiguous(), k, v, tok_slot, tok_pos, window=window,
            k_scale=k_scale, v_scale=v_scale,
        )
    else:
        out = ref.ragged_attention(
            qg, k, v, tok_slot, tok_pos, window=window, valid=valid,
            k_scale=k_scale, v_scale=v_scale,
        )
    return out.reshape(t, h, d)


def mla_ragged_attention(
    q_eff, q_rope, ckv, krope, tok_slot, tok_pos, *, scale: float,
    valid: Optional[torch.Tensor] = None,
):
    """Packed ragged attention over the MLA latent cache (latent MQA):
    q_eff [T, H, r] absorbed queries, q_rope [T, H, rope]; ckv [B, S_max, r]
    (keys and values) and krope [B, S_max, rope] with the pack's latents
    already scattered at (tok_slot, tok_pos) ([T] int32); ``scale`` the
    absorbed softmax scale ((nope + rope)**-0.5). ``valid`` optionally passes
    a precomputed ``ref.ragged_valid_mask`` to the plain version. Returns
    [T, H, r]."""
    if _step_on_cuda(q_eff):
        return _mla_k.mla_attention(
            q_eff.contiguous(), q_rope.contiguous(), ckv, krope, tok_slot, tok_pos, scale=scale,
        )
    return ref.mla_ragged_attention(
        q_eff, q_rope, ckv, krope, tok_slot, tok_pos, scale=scale, valid=valid,
    )


def paged_ragged_attention(
    q, k, v, tok_seq, tok_pos, block_tables, *, window: int = 0,
    valid: Optional[torch.Tensor] = None, k_scale=None, v_scale=None,
):
    """Packed variable-length attention against a block-paged pool: the
    ``(slot, pos)`` indirection of :func:`ragged_attention` generalised to
    ``(block, offset)`` through per-sequence block tables.

    q: [T, H, d]; k/v: pool [NB, bs, KV, d] with the packed tokens' K/V
    already scattered; tok_seq/tok_pos: [T] int32 — token t belongs to table
    row ``tok_seq[t]`` at position ``tok_pos[t]``; block_tables: [R,
    max_blocks] int32; ``k_scale``/``v_scale`` [NB, bs, KV] f32 for a
    quantized pool. The plain version gathers the tables' dense view
    (``valid`` is a ``ref.ragged_valid_mask`` over it); the kernel streams
    pool blocks through the tables and never builds it. Returns [T, H, d]."""
    t, h, d = q.shape
    kvh = k.shape[2]
    if h % kvh:
        raise ValueError(f"heads {h} not a multiple of kv heads {kvh}")
    qg = q.reshape(t, kvh, h // kvh, d)
    if _step_on_cuda(q):
        out = _paged_k.paged_attention(
            qg.contiguous(), k, v, tok_seq, tok_pos, block_tables, window=window,
            k_scale=k_scale, v_scale=v_scale,
        )
    else:
        out = ref.paged_ragged_attention(
            qg, k, v, tok_seq, tok_pos, block_tables, window=window, valid=valid,
            k_scale=k_scale, v_scale=v_scale,
        )
    return out.reshape(t, h, d)


def paged_decode_attention(
    q, k, v, cur_len, block_tables, *, window: int = 0, k_scale=None, v_scale=None,
):
    """Batched single-token decode attention against a block-paged pool.
    q: [B, H, d]; k/v: pool [NB, bs, KV, d]; cur_len: [B] int32;
    block_tables: [B, max_blocks] int32 (row b maps sequence b). The plain
    version gathers the dense view and runs the dense decode oracle —
    bit-identical to the unpaged path; the card runs the paged kernel with
    one descriptor (b, cur_len[b]) per sequence, as the JAX package does on
    the TPU, one token a tile (``decode=True``). Returns [B, H, d]."""
    b, h, d = q.shape
    kvh = k.shape[2]
    if h % kvh:
        raise ValueError(f"heads {h} not a multiple of kv heads {kvh}")
    if not _step_on_cuda(q):
        out = ref.paged_decode_attention(
            q.reshape(b, kvh, h // kvh, d), k, v, cur_len, block_tables, window=window,
            k_scale=k_scale, v_scale=v_scale,
        )
        return out.reshape(b, h, d)
    out = _paged_k.paged_attention(
        q.reshape(b, kvh, h // kvh, d).contiguous(), k, v, _seq_ids(b, q.device), cur_len,
        block_tables, window=window, k_scale=k_scale, v_scale=v_scale, decode=True,
    )
    return out.reshape(b, h, d)
