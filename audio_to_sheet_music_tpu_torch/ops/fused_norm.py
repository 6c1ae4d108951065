"""GroupNorm with the activation that follows it: the hand-written Hopper
kernel pair and its plain PyTorch version.

Replaces no TPU kernel: the JAX package leaves GroupNorm to XLA.  On the
card PyTorch's GroupNorm takes its statistics with one block a (batch,
group) row, and every norm of this model is ``GroupNorm(1, C)`` over 4-16
rows of up to 26 M elements, so a handful of blocks streamed them
(``csrc/group_norm.cu``'s header has the numbers and the design).
``nn.core.group_norm`` routes every norm of the model here on the card.

- ``group_norm``: the wrapper.  A CUDA tensor launches the two kernels
  (split-row statistics, then normalise + affine + activation) or raises;
  a CPU tensor takes ``group_norm_plain``.  ``group_norm.launches`` counts
  calls that launched the pair.  Where autograd records, the call goes
  through ``GroupNormFunction``: the forward is the pair with ``act="none"``
  and the backward is PyTorch's GroupNorm backward on f32 with the
  forward's mean and rstd; the activation then follows as its own op.
- ``group_norm_plain``: the same arithmetic in PyTorch ops: the rows cut
  into the kernel's slices, each slice's (count, mean, M2), the slices
  merged in order by Chan's formula, the biased variance, the affine in
  f32, the activation, one rounding to the input's dtype.
- ``partition``: how a row is cut into blocks, shared by both.

``act`` is ``"none"``, ``"gelu"`` (exact erf, ``F.gelu``'s default),
``"glu"`` (``a * sigmoid(b)`` over the channel halves, both normalised) or
``"silu"`` (``y * sigmoid(y)``, ``F.silu``).
``layout`` is ``"channels"`` for ``(B, C, *spatial)`` with any number of
groups dividing C (GLU: 1 or an even number), or ``"tokens"`` for a
``(B, L, C)`` stream with one group, normalised in place (no transposes:
the statistics over (L, C) do not depend on the layout); no GLU there.

The ATHT head's decoder join, the same statistics with what follows them
fused in (``csrc/group_norm.cu``'s third launch, ``gn1_join``):

- ``decoder_join``: the wrapper.  After a decoder layer's transposed
  convolution, GroupNorm(1) + GELU (where the layer has a norm), the
  linear resize of axis 2 to ``size``, the encoder skip's first C channels
  resized likewise, and ``out = x + scale * skip`` (the skip's batch may
  divide x's: batch item b takes skip item ``b mod b0``).  A CUDA tensor
  launches ``gn1_moments`` and ``gn1_coefs`` (where there is a norm) and
  ``gn1_join``, or raises; a CPU tensor takes ``decoder_join_plain``.  No
  backward: training keeps the plain chain (``models.atht``).
  ``decoder_join.launches`` counts the calls that launched.  The kernel's
  GELU takes erf by Abramowitz & Stegun 7.1.26 (see ``csrc/group_norm.cu``:
  within 4.7e-7 of the exact GELU in f32, closer than PyTorch's f32 GELU).
- ``join_table``: the kernel's tap records, cached per geometry.
- ``decoder_join_plain``: the chain the decoders ran before, op for op
  (``F.group_norm`` on f32 rounded to x's dtype, ``F.gelu``, ``lerp``,
  the skip's ``lerp``, ``skip * scale``, the add), so the CPU gives the
  bytes it gave.  The kernel computes the same algebra in f32 and rounds
  once.
- ``lerp_taps`` / ``lerp``: a linear resize's taps (f64 positions, cached
  per geometry and device) and the two-tap lerp; ``nn.core``'s resizes
  use them too.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import build

EPS = 1e-5
ACTS = ("none", "gelu", "glu", "silu")
LAYOUTS = ("channels", "tokens")
# the partition: resident blocks an SM the grid aims at, the fewest
# elements a block takes once a row is split, and the chunk's multiple
# (whole 16-byte bf16 vectors, so every block of a row shares its phase)
BLOCKS_PER_SM = 8
MIN_CHUNK = 16384
ALIGN = 8
# the most elements a channel the kernel takes (its in-channel positions
# are 32-bit)
MAX_INNER = 2 ** 29
# the H100's SMs: the partition the plain version repeats by default
H100_SMS = 132
# the decoder join (csrc/group_norm.cu): a block's threads, the positions
# a thread takes a round, the most rounds a block takes; rounds are added
# while the grid keeps JOIN_WAVES blocks an SM
JOIN_NT = 128
JOIN_U = 4
JOIN_MAX_ITERS = 16
JOIN_WAVES = 16

def partition(segments: int, length: int, sms: int) -> tuple:
    """``(blocks, chunk)``: each of ``segments`` runs of ``length``
    elements cut into ``blocks`` contiguous chunks of ``chunk`` (a multiple
    of ``ALIGN``; the last chunk may be shorter), so that segments x blocks
    fill ``sms`` x ``BLOCKS_PER_SM`` blocks, and no chunk is cut under
    ``MIN_CHUNK``: 1 block where the segments alone fill the card."""
    want = -(-sms * BLOCKS_PER_SM // segments)
    return cut(length, max(1, min(want, length // MIN_CHUNK)))


def cut(length: int, blocks: int) -> tuple:
    """``(blocks, chunk)``: ``length`` elements in at most ``blocks``
    chunks of a multiple of ``ALIGN`` elements, the last one ragged."""
    chunk = -(-length // blocks)
    chunk = -(-chunk // ALIGN) * ALIGN
    return -(-length // chunk), chunk


def geometry(shape, num_groups: int, act: str, layout: str) -> tuple:
    """``(rows, n, C, inner)`` of a norm over ``shape``: rows of n
    contiguous elements, C channels, the channel of flat element i being
    ``(i // inner) % C``.  Raises on what the kernel does not take."""
    if act not in ACTS:
        raise ValueError(f"group_norm: act {act!r}, expected one of {ACTS}")
    if layout not in LAYOUTS:
        raise ValueError(f"group_norm: layout {layout!r}, expected one of "
                         f"{LAYOUTS}")
    if len(shape) < 2 or 0 in shape:
        raise ValueError(f"group_norm: shape {tuple(shape)}")
    if layout == "tokens":
        if len(shape) != 3 or num_groups != 1 or act == "glu":
            raise ValueError("group_norm: the token layout takes (B, L, C), "
                             f"one group and no GLU; got {tuple(shape)}, "
                             f"{num_groups} groups, act {act!r}")
        b, l, c = shape
        return b, l * c, c, 1
    b, c = shape[0], shape[1]
    inner = math.prod(shape[2:])
    if num_groups < 1 or c % num_groups:
        raise ValueError(f"group_norm: {num_groups} groups of {c} channels")
    if act == "glu" and (c % 2 or (num_groups > 1 and num_groups % 2)):
        raise ValueError(f"group_norm: GLU over {c} channels in {num_groups} "
                         "groups: C must be even and the groups 1 or even")
    return b * num_groups, (c // num_groups) * inner, c, inner


def _activate(y: torch.Tensor, act: str, layout: str) -> torch.Tensor:
    if act == "gelu":
        return F.gelu(y)
    if act == "glu":
        return F.glu(y, dim=-1 if layout == "tokens" else 1)
    if act == "silu":
        return F.silu(y)
    return y


def _channel_view(t: torch.Tensor, ndim: int, layout: str) -> torch.Tensor:
    """A per-channel (C,) vector shaped to broadcast over the layout."""
    return t if layout == "tokens" else t.reshape(-1, *([1] * (ndim - 2)))


def moments_plain(x: torch.Tensor, num_groups: int, eps: float = EPS,
                  layout: str = "channels", splits: int | None = None
                  ) -> tuple:
    """Each row's ``(mean, rstd)`` in f32, as the kernel pair takes them:
    the row cut into ``splits`` slices (default: ``partition`` on an H100),
    each slice's (count, mean, M2) in two passes, merged in slice order by
    Chan's formula; ``rstd = 1 / sqrt(M2 / n + eps)``."""
    rows, n, _, _ = geometry(x.shape, num_groups, "none", layout)
    splits, chunk = (partition(rows, n, H100_SMS) if splits is None
                     else cut(n, splits))
    xf = F.pad(x.float().reshape(rows, n), (0, splits * chunk - n))
    xs = xf.reshape(rows, splits, chunk)
    cnt = (n - chunk * torch.arange(splits, device=x.device)).clamp(max=chunk)
    valid = (torch.arange(chunk, device=x.device)[None, :] < cnt[:, None])
    cnt = cnt.float()
    mean_s = xs.sum(-1) / cnt                          # pad is zero
    m2_s = ((xs - mean_s[..., None]) * valid).pow(2).sum(-1)
    tot, mean, m2 = cnt[0].expand(rows), mean_s[:, 0], m2_s[:, 0]
    for s in range(1, splits):
        nb = cnt[s]
        new = tot + nb
        d = mean_s[:, s] - mean
        f = nb / new
        mean = mean + d * f
        m2 = m2 + m2_s[:, s] + d * d * tot * f
        tot = new
    return mean, 1.0 / torch.sqrt(m2 / tot + eps)


def _apply_plain(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                 weight: torch.Tensor, bias: torch.Tensor, act: str,
                 layout: str) -> torch.Tensor:
    """Normalise with the rows' ``(mean, rstd)``, the affine in f32, the
    activation, one rounding to x's dtype."""
    rows = mean.shape[0]
    y = ((x.float().reshape(rows, -1) - mean[:, None]) * rstd[:, None]
         ).reshape(x.shape)
    y = (y * _channel_view(weight.float(), x.ndim, layout)
         + _channel_view(bias.float(), x.ndim, layout))
    return _activate(y, act, layout).to(x.dtype)


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, num_groups: int, eps: float = EPS,
                     act: str = "none", layout: str = "channels",
                     splits: int | None = None) -> torch.Tensor:
    """GroupNorm + affine + ``act`` in PyTorch ops, with the kernel pair's
    arithmetic (``moments_plain``, then ``_apply_plain``)."""
    geometry(x.shape, num_groups, act, layout)
    mean, rstd = moments_plain(x, num_groups, eps, layout, splits)
    return _apply_plain(x, mean, rstd, weight, bias, act, layout)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib() -> ctypes.CDLL:
    lib = build.load("group_norm")
    if not getattr(lib, "_bound", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.gn1_launch.argtypes = ([p, i, i, p, p, p, p, p, ll, ll, i, i, i,
                                    i, ll, ll, ll, i, ll, ctypes.c_float, p])
        lib.gn1_launch.restype = i
        lib.gn1_join_launch.argtypes = [p, i, p, p, p, p, ll, i, ll, p, p, i,
                                        p, p, ll, i, ll, ll, ll, i, i, ll, i,
                                        ctypes.c_float, ctypes.c_float, p]
        lib.gn1_join_launch.restype = i
        lib._bound = True
    return lib


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            num_groups: int, eps: float, act: str, layout: str,
            with_stats: bool = False) -> tuple:
    """The kernel pair on a CUDA ``x``: ``(out, stats)``, ``stats`` the
    rows' ``(mean, rstd)`` as an f32 ``(rows, 2)`` where asked for (act
    none), else None."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"group_norm: x must be bfloat16 or float32, got "
                        f"{x.dtype}")
    rows, n, c, inner = geometry(x.shape, num_groups, act, layout)
    if inner > MAX_INNER:
        raise ValueError(f"group_norm: a channel of {inner} elements, the "
                         f"kernel takes at most {MAX_INNER}")
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"group_norm: affine {tuple(weight.shape)} / "
                         f"{tuple(bias.shape)} for {c} channels")
    dev = x.device
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    w = build.f32(weight, dev, "group_norm")
    b = build.f32(bias, dev, "group_norm")
    out_shape = list(x.shape)
    if act == "glu":
        out_shape[1] //= 2
    out = torch.empty(out_shape, dtype=x.dtype, device=dev)
    sms = _sms(dev.index if dev.index is not None
               else torch.cuda.current_device())
    splits, chunk1 = partition(rows, n, sms)
    if act == "glu" and num_groups == 1:
        segments, seg_len = rows, n // 2
    elif act == "glu":
        segments, seg_len = rows // 2, n
    else:
        segments, seg_len = rows, n
    bps, chunk2 = partition(segments, seg_len, sms)
    part = torch.empty((rows, splits, 3), dtype=torch.float32, device=dev)
    stats = (torch.empty((rows, 2), dtype=torch.float32, device=dev)
             if with_stats else None)
    build.launch(
        "group_norm", dev, _lib().gn1_launch, x.data_ptr(),
        1 if x.dtype == torch.bfloat16 else 0, ACTS.index(act), w.data_ptr(),
        b.data_ptr(), out.data_ptr(), part.data_ptr(),
        None if stats is None else stats.data_ptr(), rows, n, c, num_groups,
        inner, splits, chunk1, segments, seg_len, bps, chunk2, eps,
        torch.cuda.current_stream(dev).cuda_stream)
    group_norm.launches += 1
    return out, stats


class GroupNormFunction(torch.autograd.Function):
    """GroupNorm with a backward: the kernel pair forward (``act="none"``;
    the plain version on a CPU tensor), PyTorch's
    ``native_group_norm_backward`` on the f32 gradient and input with the
    forward's mean and rstd."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, layout):
        if x.device.type == "cuda":
            out, stats = _launch(x, weight, bias, num_groups, eps, "none",
                                 layout, with_stats=True)
            # contiguous: the backward kernel indexes them as (N, G) arrays
            mean, rstd = stats[:, 0].contiguous(), stats[:, 1].contiguous()
        else:
            mean, rstd = moments_plain(x, num_groups, eps, layout)
            out = _apply_plain(x, mean, rstd, weight, bias, "none", layout)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.groups, ctx.layout = num_groups, layout
        return out

    @staticmethod
    def backward(ctx, grad):
        x, weight, mean, rstd = ctx.saved_tensors
        g = ctx.groups
        gf, xf = grad.float(), x.float()
        if ctx.layout == "tokens":
            gf, xf = gf.transpose(1, 2), xf.transpose(1, 2)
        gf, xf = gf.contiguous(), xf.contiguous()
        n, c = xf.shape[:2]
        dx, dw, db = torch.ops.aten.native_group_norm_backward(
            gf, xf, mean.reshape(n, g), rstd.reshape(n, g), weight.float(),
            n, c, xf[0, 0].numel(), g, list(ctx.needs_input_grad[:3]))
        if dx is not None:
            dx = dx.transpose(1, 2) if ctx.layout == "tokens" else dx
            dx = dx.to(x.dtype)
        return dx, dw, db, None, None, None


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = EPS, act: str = "none",
               layout: str = "channels") -> torch.Tensor:
    """GroupNorm + per-channel affine + ``act`` (see the module notes).

    CPU tensors take ``group_norm_plain``.  A CUDA ``x`` must be bf16 or
    f32 with a ``(C,)`` weight and bias on its card, else this raises.
    Where autograd records, the norm goes through ``GroupNormFunction``
    and ``act`` follows as its own op."""
    if x.device.type == "cpu":
        return group_norm_plain(x, weight, bias, num_groups, eps, act, layout)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm: no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weight, bias)):
        geometry(x.shape, num_groups, act, layout)
        y = GroupNormFunction.apply(x, weight, bias, num_groups, eps, layout)
        return _activate(y, act, layout)
    return _launch(x, weight, bias, num_groups, eps, act, layout)[0]


group_norm.launches = 0


# ---------------------------------------------------------------------------
# The decoder join
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def lerp_taps(in_size: int, size: int, device: torch.device) -> tuple:
    """Source taps of torch's ``align_corners=False`` linear resize, with the
    positions computed in float64 as the JAX package does (``F.interpolate``
    computes them in float32, which moves a 11028 -> 11025 resize by up to
    ~1e-3 of a sample near the end): ``(i0, i1, frac)`` on ``device``,
    int64, int64, f32.  An exact /4 decimation gives (4i+1, 4i+2, 0.5).
    Kept per geometry and device: copying host arrays to the card on every
    call would wait for the card each time (a pageable host-to-device copy
    synchronises), which would serialise the replicas of a mesh sweep and
    cannot be captured in a CUDA graph.  Made outside inference mode, so a
    training step can use the taps that a sweep made."""
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(a).to(device)
                     for a in _taps(in_size, size))


def _taps(in_size: int, size: int) -> tuple:
    """``lerp_taps`` on the host, as numpy arrays; the identity where the
    sizes agree."""
    if in_size == size:
        i = np.arange(size)
        return i, i, np.zeros(size, np.float32)
    src = (np.arange(size) + 0.5) * (in_size / size) - 0.5
    i0f = np.floor(src)
    frac = (src - i0f).astype(np.float32)
    i0 = np.clip(i0f.astype(np.int64), 0, in_size - 1)
    i1 = np.clip(i0f.astype(np.int64) + 1, 0, in_size - 1)
    return i0, i1, frac


@functools.lru_cache(maxsize=64)
def join_table(rows_y: int, rows_skip: int, size: int, width: int,
               device: torch.device) -> tuple:
    """The join kernels' tap records for ``size`` output rows of ``width``
    elements, from ``rows_y`` rows of y and ``rows_skip`` of the skip
    (``lerp_taps``' taps, or the row itself where the sizes agree):
    ``(tab, frac)``, tab (size, 4) int32 the tap rows' first elements (y's
    two, the skip's two), frac (size, 2) f32 the second taps' weights.
    Kept per geometry and device, as ``lerp_taps`` keeps its taps."""
    y0, y1, fy = _taps(rows_y, size)
    s0, s1, fs = _taps(rows_skip, size)
    tab = np.stack([y0, y1, s0, s1], 1).astype(np.int64) * width
    with torch.inference_mode(False):
        return (torch.from_numpy(tab.astype(np.int32)).to(device),
                torch.from_numpy(np.stack([fy, fs], 1)).to(device))


def lerp(x: torch.Tensor, taps: tuple, dim: int) -> torch.Tensor:
    """``x`` resized along ``dim`` by ``taps`` (``lerp_taps``): the two
    gathered taps and their lerp in f32, rounded once to x's dtype."""
    i0, i1, frac = taps
    shape = [1] * x.ndim
    shape[dim] = frac.shape[0]
    f = frac.reshape(shape)
    x0 = x.index_select(dim, i0).float()
    x1 = x.index_select(dim, i1).float()
    return (x0 * (1.0 - f) + x1 * f).to(x.dtype)


def check_join(y: torch.Tensor, weight, bias, skip: torch.Tensor,
               size: int) -> None:
    """Raises on what the join does not take: y ``(B, C, A, *rest)``, skip
    ``(b0, Cs, As, *rest)`` with ``b0 | B``, ``Cs >= C`` and the same
    ``rest``; a ``(C,)`` affine or none."""
    if y.ndim < 3 or skip.ndim != y.ndim or 0 in y.shape or 0 in skip.shape:
        raise ValueError(f"decoder_join: y {tuple(y.shape)}, skip "
                         f"{tuple(skip.shape)}: (B, C, A, *rest) each")
    b, c = y.shape[:2]
    b0, cs = skip.shape[:2]
    if b % b0 or cs < c or skip.shape[3:] != y.shape[3:] or size < 1:
        raise ValueError(f"decoder_join: y {tuple(y.shape)}, skip "
                         f"{tuple(skip.shape)}, size {size}: the skip's "
                         "batch must divide y's, its channels cover y's "
                         "and its axes after the resized one equal y's")
    if (weight is None) != (bias is None) or (
            weight is not None and (weight.shape != (c,)
                                    or bias.shape != (c,))):
        raise ValueError(f"decoder_join: affine of {c} channels, got "
                         f"{None if weight is None else tuple(weight.shape)}"
                         f" / {None if bias is None else tuple(bias.shape)}")


def decoder_join_plain(y: torch.Tensor, weight, bias, skip: torch.Tensor,
                       size: int, scale: float, eps: float = EPS
                       ) -> torch.Tensor:
    """The join as the decoders composed it before the kernel: GroupNorm(1)
    on f32 rounded to y's dtype, GELU, the resize, the skip's resize, the
    scaled skip added (each op rounding to y's dtype)."""
    check_join(y, weight, bias, skip, size)
    h = y
    if weight is not None:
        h = F.gelu(F.group_norm(y.float(), 1, weight.float(), bias.float(),
                                eps).to(y.dtype))
    if h.shape[2] != size:
        h = lerp(h, lerp_taps(h.shape[2], size, h.device), 2)
    s = skip[:, : y.shape[1]]
    if s.shape[2] != size:
        s = lerp(s, lerp_taps(s.shape[2], size, s.device), 2)
    contrib = s.to(h.dtype) * scale
    b, b0 = h.shape[0], s.shape[0]
    if b == b0:
        return h + contrib
    return (h.reshape(b // b0, b0, *h.shape[1:]) + contrib[None]).reshape(
        h.shape)


def join_iters(groups: int, length: int, sms: int) -> int:
    """Rounds of ``JOIN_U`` x ``JOIN_NT`` positions a block of the join
    takes over its ``groups`` skip planes of ``length`` output positions:
    as many as keep ``JOIN_WAVES`` blocks an SM, at most
    ``JOIN_MAX_ITERS``."""
    blocks = groups * -(-length // (JOIN_U * JOIN_NT))
    return max(1, min(JOIN_MAX_ITERS, blocks // (JOIN_WAVES * sms)))


def decoder_join(y: torch.Tensor, weight, bias, skip: torch.Tensor,
                 size: int, scale: float, eps: float = EPS) -> torch.Tensor:
    """The decoder join (see the module notes): ``(B, C, size, *rest)`` in
    y's dtype.  ``weight`` / ``bias`` None: no norm (the last layer).

    CPU tensors take ``decoder_join_plain``.  On a card y and skip must be
    bf16 or f32 alike, on y's card, with no gradient to record, else this
    raises."""
    if y.device.type == "cpu":
        return decoder_join_plain(y, weight, bias, skip, size, scale, eps)
    if y.device.type != "cuda":
        raise ValueError(f"decoder_join: no kernel for device {y.device}")
    build.check_no_grad("decoder_join", y, weight, bias, skip)
    if y.dtype not in (torch.bfloat16, torch.float32) or skip.dtype != y.dtype:
        raise TypeError(f"decoder_join: y {y.dtype} and skip {skip.dtype} "
                        "must be bfloat16 or float32 alike")
    if skip.device != y.device:
        raise ValueError(f"decoder_join: skip on {skip.device}, y on "
                         f"{y.device}")
    check_join(y, weight, bias, skip, size)
    dev = y.device
    y = y.contiguous()
    if y.data_ptr() % 16:
        y = y.clone()
    skip = skip.contiguous()
    b, c, a = y.shape[:3]
    rest = math.prod(y.shape[3:])
    out = torch.empty((b, c, size, *y.shape[3:]), dtype=y.dtype, device=dev)
    sms = _sms(dev.index if dev.index is not None
               else torch.cuda.current_device())
    tab, frac = join_table(a, skip.shape[2], size, rest, dev)
    w = bb = part = coefs = None
    n = splits = chunk1 = 0
    if weight is not None:
        w = build.f32(weight, dev, "decoder_join")
        bb = build.f32(bias, dev, "decoder_join")
        n = c * a * rest
        splits, chunk1 = partition(b, n, sms)
        part = torch.empty((b, splits, 3), dtype=torch.float32, device=dev)
        coefs = torch.empty((b * c, 4), dtype=torch.float32, device=dev)
    build.launch(
        "decoder_join", dev, _lib().gn1_join_launch, y.data_ptr(),
        1 if y.dtype == torch.bfloat16 else 0, *(
            None if t is None else t.data_ptr() for t in (w, bb, part, coefs)),
        n, splits, chunk1, tab.data_ptr(), frac.data_ptr(),
        int(a != size), skip.data_ptr(), out.data_ptr(), b, c, a, size,
        rest, skip.shape[1], skip.shape[0], skip.shape[2],
        join_iters(skip.shape[0] * c, size * rest, sms), eps, scale,
        torch.cuda.current_stream(dev).cuda_stream)
    decoder_join.launches += 1
    return out


decoder_join.launches = 0
