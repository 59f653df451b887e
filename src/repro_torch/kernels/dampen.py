"""Dampening IP on Hopper — port of ``repro.kernels.dampen.dampen``,
``dampen_int8`` and ``dampen_int8_rowscale``.

The TPU kernels (``_dampen_kernel``, ``_dampen_int8_kernel``,
``_dampen_int8_rowscale_kernel``) are one fused elementwise pass of SSD
Eqs. (3)+(4): select ``i_f > alpha * i_g``,
``beta = min(lam * i_g / max(i_f, 1e-30), 1)``, multiply — on float
weights, or on int8 weight codes with ``round`` (half to even) and a clip
to ±127 (the ``precision="int8"`` path); the rowscale variant first
dequantises a quant-domain forget Fisher, ``i_f = i_fq * fs[row]``. Here
all three are ``csrc/dampen.cu``, CUDA C++ for ``sm_90a``, one shared
library with a plain C interface (``kernels/build.py``) bound with ctypes.
The float and int8 kernels also write the selection mask from the same
pass; the rowscale kernel returns the codes only, as the reference's
wrapper does. They are bound by device memory (17 bytes per element for
f32 theta, 13 for bf16, 11 for int8 codes, 10 for rowscale); the source
says what the design does about that.

The float and int8 kernels take a table of leaves per launch:
``dampen_group_cuda`` / ``dampen_int8_group_cuda`` dampen a layer's leaves
(or a whole tree) in one launch per ``MAX_LEAVES`` leaves, write all masks
into one buffer, and return the number of selected elements from the same
pass, so a forget request launches once per layer and sums no masks.
``table_plan`` lays the table out on the host: per leaf its pointers, its
first block and whether it may take the 16-byte path. The per-leaf
``dampen_cuda`` / ``dampen_int8_cuda`` are tables of one.

The rowscale kernel is the same kernel body over a table of the parts of
one leaf [R, C], one launch per leaf (``rowscale_plan``): a leaf of fewer
than 2^31 elements is one part, a larger one is cut into parts of whole
rows (or, for a row of 2^31 elements or more, pieces of it) that each
hold fewer, so that the card's index math is 32-bit. Each part carries
its row length and the multiplier and shift that divide by it
(``fast_divisor``), so the card finds an element's row without a divide.

Why CUDA C++ and not Triton: the kernel must agree with ``dampen_ref`` bit
for bit, and Triton lowers an f32 ``/`` to the approximate
``div.full.f32``; nvcc's divide is correctly rounded as long as the build
never uses ``--use_fast_math`` (``build.NVCC_FLAGS`` does not).

``LAUNCHES`` counts launches of the float kernel, ``INT8_LAUNCHES`` those
of the int8 one and ``ROWSCALE_LAUNCHES`` those of the rowscale one, and
nothing else, so a run shows which kernel an edit took; ``LEAVES`` and
``INT8_LEAVES`` count the leaves that the float and int8 launches
dampened.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.optim.compression import int8_codes

from . import build as _build

F32 = torch.float32

_ENTRY = {F32: "ficabu_dampen_group_f32",
          torch.bfloat16: "ficabu_dampen_group_bf16"}
_ENTRY_INT8 = "ficabu_dampen_group_int8"
_ENTRY_ROWSCALE = "ficabu_dampen_int8_rowscale"

# as csrc/dampen.cu takes them: leaves in one launch's parameter table, and
# the elements one block takes from its leaf (a multiple of 4 x 256 threads)
MAX_LEAVES = 64
ELEMS_PER_BLOCK = 1024
# a rowscale launch's table: at most MAX_ROW_PARTS parts of one leaf, each
# of at most PART_LIMIT elements (the kernel's index math is 32-bit); 16
# parts hold 34 billion elements, more than a card's memory
MAX_ROW_PARTS = 16
PART_LIMIT = 2 ** 31 - 1
# a grouped call puts each leaf's mask (and output) at a 16-byte boundary
# of one buffer
_ALIGN = 16
# a grouped call's count is a slot of a slab of int64 zeros on the card,
# each slot used once; a new slab (one fill kernel) every _SLOTS calls
_SLOTS = 64

LAUNCHES = 0           # float-kernel launches since the last reset
LEAVES = 0             # leaves those launches dampened
INT8_LAUNCHES = 0      # int8-kernel launches since the last reset
INT8_LEAVES = 0        # leaves those launches dampened
ROWSCALE_LAUNCHES = 0  # rowscale-kernel launches since the last reset
BUILD_LOG = ""  # nvcc's output (register use, spills) when this process built
_LIB: Optional[ctypes.CDLL] = None
# (device index, stream) -> [slab of zeros, index of its next free slot]
_COUNT_SLABS: Dict[Tuple[int, int], list] = {}


def dampen_ref(theta: torch.Tensor, i_f: torch.Tensor, i_g: torch.Tensor,
               alpha: float, lam: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: Eqs. (3)+(4) in f32, output in theta's
    dtype, plus the selection mask. ``alpha``/``lam`` must already be
    rounded to f32 (``kernels.ops.dampen`` does it), so the product
    ``alpha * i_g`` is the correctly rounded f32 product either way."""
    sel, beta = _select_beta(i_f, i_g, alpha, lam)
    th32 = theta.to(F32)
    out = torch.where(sel, th32 * beta, th32)
    return out.to(theta.dtype), sel


def dampen_int8_ref(theta_q: torch.Tensor, i_f: torch.Tensor,
                    i_g: torch.Tensor, alpha: float, lam: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the int8 kernel: Eqs. (3)+(4) on int8
    weight codes, ``round`` half to even, clipped to ±127, NaN -> code 0
    (as XLA converts). Returns (codes', mask); ``alpha``/``lam`` as in
    ``dampen_ref``."""
    sel, beta = _select_beta(i_f, i_g, alpha, lam)
    th32 = theta_q.to(F32)
    return int8_codes(torch.where(sel, torch.round(th32 * beta), th32)), sel


def _select_beta(i_f, i_g, alpha, lam):
    i_f32 = i_f.to(F32)
    i_g32 = i_g.to(F32)
    sel = i_f32 > alpha * i_g32
    # clamp_min/clamp_max propagate NaN, as jnp.maximum/jnp.minimum do
    beta = (lam * i_g32 / i_f32.clamp_min(1e-30)).clamp_max(1.0)
    return sel, beta


def check_elementwise(name: str, theta: torch.Tensor, i_f: torch.Tensor,
                      i_g: torch.Tensor) -> None:
    """The reference's shape check (``repro.kernels.ops``), its text too."""
    if i_f.shape != theta.shape or i_g.shape != theta.shape:
        raise ValueError(
            f"{name} is elementwise: Fisher operands must match theta's "
            f"shape {tuple(theta.shape)}, got i_f={tuple(i_f.shape)}, "
            f"i_g={tuple(i_g.shape)}")


def check_int8_codes(theta_q: torch.Tensor) -> None:
    """The reference's dtype check of ``dampen_int8``, its text too."""
    if theta_q.dtype != torch.int8:
        raise ValueError(
            f"dampen_int8 edits int8 weight codes in place (use dampen for "
            f"float weights), got theta_q dtype {theta_q.dtype}")


def check_lengths(name: str, thetas, i_fs, i_gs, outs) -> None:
    """A table holds one i_f, i_g (and out) per theta."""
    if not len(thetas) == len(i_fs) == len(i_gs) or (
            outs is not None and len(outs) != len(thetas)):
        raise ValueError(
            f"{name} takes one i_f, i_g (and out) per theta, got "
            f"{len(thetas)} theta, {len(i_fs)} i_f, {len(i_gs)} i_g and "
            f"{'no' if outs is None else len(outs)} out tensors")


def dampen_int8_rowscale_ref(theta_q: torch.Tensor, i_fq: torch.Tensor,
                             f_scale: torch.Tensor, i_g: torch.Tensor,
                             alpha: float, lam: float) -> torch.Tensor:
    """The plain PyTorch version of the rowscale kernel: the forget Fisher
    ``i_fq`` [R, C] (any real dtype, taken as f32) times its per-row f32
    scale ``f_scale`` [R], then the int8 rule of ``dampen_int8_ref``.
    Returns the codes only, as the reference's wrapper does."""
    i_f = i_fq.to(F32) * f_scale.to(F32)[:, None]
    return dampen_int8_ref(theta_q, i_f, i_g, alpha, lam)[0]


def dampen_group_ref(thetas: Sequence[torch.Tensor],
                     i_fs: Sequence[torch.Tensor],
                     i_gs: Sequence[torch.Tensor], alpha: float, lam: float
                     ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                                torch.Tensor]:
    """The plain version of one grouped launch: ``dampen_ref`` per leaf,
    plus the number of selected elements over all leaves (an int64 scalar).
    Returns (thetas', masks, count)."""
    return _group_ref(dampen_ref, thetas, i_fs, i_gs, alpha, lam)


def dampen_int8_group_ref(thetas_q: Sequence[torch.Tensor],
                          i_fs: Sequence[torch.Tensor],
                          i_gs: Sequence[torch.Tensor], alpha: float,
                          lam: float
                          ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                                     torch.Tensor]:
    """``dampen_group_ref`` on int8 codes: ``dampen_int8_ref`` per leaf
    plus the count. Returns (codes', masks, count)."""
    return _group_ref(dampen_int8_ref, thetas_q, i_fs, i_gs, alpha, lam)


def _group_ref(fn, thetas, i_fs, i_gs, alpha, lam):
    res = [fn(t, f, g, alpha, lam) for t, f, g in zip(thetas, i_fs, i_gs)]
    dev = thetas[0].device if len(thetas) else "cpu"
    count = torch.zeros((), dtype=torch.int64, device=dev)
    for _, mask in res:
        count = count + mask.sum()
    return [r[0] for r in res], [r[1] for r in res], count


def table_plan(ns: Sequence[int], ptrs: Sequence[Sequence[int]],
               theta_size: int) -> List[Tuple[np.ndarray, int]]:
    """The launches of one grouped call, computed on the host.

    ``ns`` are the leaves' element counts and ``ptrs`` their (theta, i_f,
    i_g, out, mask) addresses; ``theta_size`` is theta's element size in
    bytes. The leaves go in order, at most ``MAX_LEAVES`` per launch. Per
    launch: its table, an int64 array [k, 8] of rows (theta, i_f, i_g, out,
    mask, n, first block, vec), as ``csrc/dampen.cu`` reads them, and its
    block count. Leaf i of a launch owns the blocks [first block,
    first block + ceil(n / ELEMS_PER_BLOCK)); ``vec`` is 1 when every
    pointer is aligned for the kernel's 4-element path (16 bytes for i_f and
    i_g, 4 elements for theta and out, 4 bytes for the mask), else the leaf
    takes the scalar path."""
    launches = []
    for lo in range(0, len(ns), MAX_LEAVES):
        rows, first = [], 0
        for n, (th, f, g, o, m) in zip(ns[lo:lo + MAX_LEAVES],
                                       ptrs[lo:lo + MAX_LEAVES]):
            vec = (th % (4 * theta_size) == 0 and o % (4 * theta_size) == 0
                   and f % 16 == 0 and g % 16 == 0 and m % 4 == 0)
            rows.append((th, f, g, o, m, n, first, int(vec)))
            first += -(-n // ELEMS_PER_BLOCK)
        launches.append((np.array(rows, dtype=np.int64).reshape(-1, 8),
                         first))
    return launches


def fast_divisor(d: int) -> Tuple[int, int]:
    """The multiplier and shift that divide by ``d`` (1 <= d < 2^31) on
    the card: ``e // d == umulhi(2 * e, mul) >> shr`` for every
    0 <= e < 2^31, with ``umulhi`` the high 32 bits of a 32-bit product.
    With ``shr = ceil(log2 d)`` and ``mul = ceil(2^(31 + shr) / d)`` (under
    2^32) this is Granlund and Montgomery's round-up method for 31-bit
    dividends; the doubled dividend folds their extra shift into the
    multiply, so that d = 1 needs no case of its own."""
    shr = (d - 1).bit_length()
    return -(-(1 << (31 + shr)) // d), shr


def rowscale_parts(R: int, C: int, limit: int = PART_LIMIT
                   ) -> List[Tuple[int, int, int, int]]:
    """The parts of a rowscale leaf [R, C], each (first row, first element,
    elements, row length), in order, together every element once.

    A part holds at most ``limit`` (>= 4) elements. Where a row fits, a
    part is whole rows, as many as fit, a multiple of 4 where 4 fit, so
    that every part starts at a multiple of 4 elements and a leaf on the
    16-byte path stays on it; a leaf of at most ``limit`` elements is one
    part. A longer row is cut into pieces of at most ``limit`` rounded
    down to a multiple of 4, each a row of its own (its row length its own
    length)."""
    parts = []
    if C <= limit:
        q = limit // C
        q -= q % 4 if q >= 4 else 0
        for r in range(0, R, q):
            parts.append((r, r * C, min(q, R - r) * C, C))
    else:
        piece = limit - limit % 4
        for r in range(R):
            for j in range(0, C, piece):
                m = min(piece, C - j)
                parts.append((r, r * C + j, m, m))
    return parts


def rowscale_plan(R: int, C: int, ptrs: Sequence[int],
                  limit: int = PART_LIMIT) -> Tuple[np.ndarray, int]:
    """The launch of one rowscale call, computed on the host.

    ``ptrs`` are the leaf's (theta_q, i_fq, fs, i_g, out) addresses (int8,
    f32, f32, f32, int8). Returns the launch's table, an int64 array
    [k, 11] of rows (theta, i_fq, fs, i_g, out, n, first block, vec, C,
    mul, shr), one per part of ``rowscale_parts`` in order, as
    ``csrc/dampen.cu`` reads them, the pointers moved to the part's first
    element and first row; and its block count. ``vec`` is 1 when the
    part's pointers allow the 4-element path (16 bytes for i_fq and i_g, 4
    for theta and out). More than ``MAX_ROW_PARTS`` parts raise."""
    th, f, s, g, o = ptrs
    parts = rowscale_parts(R, C, limit)
    if len(parts) > MAX_ROW_PARTS:
        raise ValueError(
            f"dampen_int8_rowscale takes a leaf of at most {MAX_ROW_PARTS} "
            f"parts of {limit} elements, got [{R}, {C}] in {len(parts)}")
    rows, first = [], 0
    for r, e, n, c in parts:
        vec = ((th + e) % 4 == 0 and (o + e) % 4 == 0
               and (f + 4 * e) % 16 == 0 and (g + 4 * e) % 16 == 0)
        rows.append((th + e, f + 4 * e, s + 4 * r, g + 4 * e, o + e, n,
                     first, int(vec), c, *fast_divisor(c)))
        first += -(-n // ELEMS_PER_BLOCK)
    return np.array(rows, dtype=np.int64).reshape(-1, 11), first


def build() -> Path:
    """Compile ``csrc/dampen.cu`` for sm_90a if this exact source and flag
    set has not been built yet; returns the shared library's path."""
    global BUILD_LOG
    so = _build.build("dampen")
    BUILD_LOG = _build.BUILD_LOG.get("dampen", BUILD_LOG)
    return so


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        build()
        lib = _build.load("dampen")
        for name in (*_ENTRY.values(), _ENTRY_INT8):
            _build.bind(lib, name, [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                ctypes.c_void_p])
        _build.bind(lib, _ENTRY_ROWSCALE, [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
            ctypes.c_float, ctypes.c_void_p])
        _LIB = lib
    return _LIB


def dampen_cuda(theta: torch.Tensor, i_f: torch.Tensor, i_g: torch.Tensor,
                alpha: float, lam: float,
                out: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the float kernel on one leaf (a table of one) of any shape;
    returns (theta', mask). ``out`` may be ``theta`` itself (an in-place
    edit). Launches on the current stream and does not synchronise."""
    outs, masks, _ = dampen_group_cuda([theta], [i_f], [i_g], alpha, lam,
                                       None if out is None else [out],
                                       count=False)
    return outs[0], masks[0]


def dampen_int8_cuda(theta_q: torch.Tensor, i_f: torch.Tensor,
                     i_g: torch.Tensor, alpha: float, lam: float,
                     out: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the int8 kernel on one leaf (a table of one) of any shape;
    returns (codes', mask). ``out`` may be ``theta_q`` itself (an in-place
    edit). Launches on the current stream and does not synchronise."""
    outs, masks, _ = dampen_int8_group_cuda([theta_q], [i_f], [i_g], alpha,
                                            lam, None if out is None
                                            else [out], count=False)
    return outs[0], masks[0]


def dampen_group_cuda(thetas: Sequence[torch.Tensor],
                      i_fs: Sequence[torch.Tensor],
                      i_gs: Sequence[torch.Tensor], alpha: float, lam: float,
                      outs: Optional[Sequence[torch.Tensor]] = None, *,
                      count: bool = True
                      ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                                 Optional[torch.Tensor]]:
    """Launch the float kernel once over a table of CUDA leaves (one launch
    per ``MAX_LEAVES``), all f32 or all bf16, any shapes; returns (thetas',
    masks, count), ``count`` the number of selected elements as an int64
    scalar on the card (None with ``count=False``). A Fisher operand of
    another float dtype, or a non-contiguous theta or Fisher operand, is
    converted first. ``outs[i]`` (contiguous) may be ``thetas[i]`` itself
    (an in-place edit); without ``outs`` the thetas' are views into one new
    buffer. Launches on the current stream and does not synchronise."""
    global LAUNCHES, LEAVES
    dt = thetas[0].dtype if len(thetas) else F32
    if dt not in _ENTRY:
        raise ValueError(f"the dampen kernel takes f32 or bf16 theta, got "
                         f"{dt}")
    res, launches = _launch(_ENTRY[dt], "dampen", thetas, i_fs, i_gs, alpha,
                            lam, outs, count)
    LAUNCHES += launches
    LEAVES += len(thetas) if launches else 0
    return res


def dampen_int8_group_cuda(thetas_q: Sequence[torch.Tensor],
                           i_fs: Sequence[torch.Tensor],
                           i_gs: Sequence[torch.Tensor], alpha: float,
                           lam: float,
                           outs: Optional[Sequence[torch.Tensor]] = None, *,
                           count: bool = True
                           ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                                      Optional[torch.Tensor]]:
    """``dampen_group_cuda`` on int8 codes: one launch of the int8 kernel
    per ``MAX_LEAVES`` leaves; returns (codes', masks, count)."""
    global INT8_LAUNCHES, INT8_LEAVES
    if len(thetas_q):
        check_int8_codes(thetas_q[0])
    res, launches = _launch(_ENTRY_INT8, "dampen_int8", thetas_q, i_fs, i_gs,
                            alpha, lam, outs, count)
    INT8_LAUNCHES += launches
    INT8_LEAVES += len(thetas_q) if launches else 0
    return res


def _launch(entry: str, what: str, thetas, i_fs, i_gs, alpha, lam, outs,
            count: bool, converted: bool = False):
    """Check the operands (every theta of the first one's dtype), allocate
    one buffer for all masks and, unless ``outs`` is given, one for all
    outputs, and launch ``entry`` over the table: once per ``MAX_LEAVES``
    leaves that hold an element. With ``count`` the launches add the
    selected elements to one fresh zero on the card (``_count_slot``).
    Returns ((outs, masks, count), launches).

    The host's time per leaf is what a layer's launch costs beyond the
    kernel, so this is the card path's only check of a leaf (``kernels.ops``
    adds none), one expression per leaf. A table that fails it is converted
    as the reference converts its operands (contiguous theta, Fisher in
    f32) and checked again, and a leaf that still fails is refused with the
    reference's texts (``_refuse``). The outputs and masks are views into
    one allocation each."""
    check_lengths(f"{what} kernel", thetas, i_fs, i_gs, outs)
    if not len(thetas):
        return ([], [], None), 0
    dev, dt = thetas[0].device, thetas[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"{what}_cuda takes CUDA tensors, got theta on {dev}")
    for theta, i_f, i_g, out in zip(thetas, i_fs, i_gs,
                                    thetas if outs is None else outs):
        shape = theta.shape
        if not (theta.dtype == dt and out.dtype == dt and i_f.dtype == F32
                and i_g.dtype == F32 and i_f.shape == shape
                and i_g.shape == shape and out.shape == shape
                and theta.is_contiguous() and i_f.is_contiguous()
                and i_g.is_contiguous() and out.is_contiguous()
                and theta.device == dev and i_f.device == dev
                and i_g.device == dev and out.device == dev):
            if not converted:
                return _launch(entry, what, [t.contiguous() for t in thetas],
                               [f.to(F32).contiguous() for f in i_fs],
                               [g.to(F32).contiguous() for g in i_gs], alpha,
                               lam, outs, count, converted=True)
            _refuse(what, dev, dt, theta, i_f, i_g, out)
    ns = [t.numel() for t in thetas]
    mask_at = _offsets(ns, _ALIGN)
    buf = torch.empty(mask_at[-1], dtype=torch.bool, device=dev)
    # a view per leaf at its offset (theta is contiguous: its strides are
    # the mask's and the output's)
    masks = [buf.as_strided(t.shape, t.stride(), o)
             for t, o in zip(thetas, mask_at)]
    if outs is None:
        out_at = _offsets(ns, _ALIGN // thetas[0].element_size())
        obuf = torch.empty(out_at[-1], dtype=dt, device=dev)
        outs = [obuf.as_strided(t.shape, t.stride(), o)
                for t, o in zip(thetas, out_at)]
    base = buf.data_ptr()
    plan = table_plan(ns, [(th.data_ptr(), f.data_ptr(), g.data_ptr(),
                            o.data_ptr(), base + off) for th, f, g, o, off
                           in zip(thetas, i_fs, i_gs, outs, mask_at)],
                      thetas[0].element_size())
    fn = getattr(_lib(), entry)
    launches = 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        n_sel = _count_slot(dev, stream) if count else None
        for rows, blocks in plan:
            if not blocks:
                continue
            err = fn(rows.ctypes.data, len(rows), blocks, alpha, lam,
                     None if n_sel is None else n_sel.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"{what} kernel launch failed: cudaError "
                                   f"{err}")
            launches += 1
    return (outs, masks, n_sel), launches


def _count_slot(dev: torch.device, stream: int) -> torch.Tensor:
    """An int64 zero on the card, owned by one call: the next slot of the
    stream's slab of zeros. A new slab (one fill kernel on the stream) every
    ``_SLOTS`` calls; a slot is never handed out twice, and a slab lives as
    long as a count taken from it."""
    key = (dev.index, stream)
    entry = _COUNT_SLABS.get(key)
    if entry is None or entry[1] == _SLOTS:
        entry = _COUNT_SLABS[key] = [
            torch.zeros(_SLOTS, dtype=torch.int64, device=dev), 0]
    slab, i = entry
    entry[1] = i + 1
    return slab[i]


def _offsets(ns: Sequence[int], align: int) -> List[int]:
    """Each leaf's offset in a buffer that puts every leaf at a multiple of
    ``align``; the last entry is the buffer's length."""
    at = [0]
    for n in ns:
        at.append(at[-1] + -(-n // align) * align)
    return at


def _refuse(what, dev, dt, theta, i_f, i_g, out):
    """Raise the ValueError that says why a leaf failed ``_launch``'s
    check: the reference's texts for a shape or an int8 dtype, else the
    operand that the kernel cannot take."""
    check_elementwise(what, theta, i_f, i_g)
    if what == "dampen_int8":
        check_int8_codes(theta)
    for name, t, want in (("i_f", i_f, F32), ("i_g", i_g, F32),
                          ("theta", theta, dt), ("out", out, dt)):
        if t.device != dev or t.dtype != want or not t.is_contiguous() \
                or t.shape != theta.shape:
            raise ValueError(
                f"{what} kernel operand {name} must be a contiguous {want} "
                f"tensor of shape {tuple(theta.shape)} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")


def dampen_int8_rowscale_cuda(theta_q: torch.Tensor, i_fq: torch.Tensor,
                              f_scale: torch.Tensor, i_g: torch.Tensor,
                              alpha: float, lam: float) -> torch.Tensor:
    """Launch the rowscale kernel on contiguous CUDA tensors: theta_q
    [R, C] int8, i_fq [R, C] f32, f_scale [R] f32, i_g [R, C] f32; returns
    the codes [R, C] int8 in a new tensor. One launch over the table of the
    leaf's parts of at most ``PART_LIMIT`` elements (``rowscale_plan``; a
    leaf of fewer than 2^31 elements is a table of one). Launches on the
    current stream and does not synchronise."""
    global ROWSCALE_LAUNCHES
    dev = theta_q.device
    if dev.type != "cuda":
        raise ValueError(f"dampen_int8_rowscale_cuda takes CUDA tensors, got "
                         f"theta_q on {dev}")
    if theta_q.dtype != torch.int8 or theta_q.ndim != 2:
        raise ValueError(f"the dampen_int8_rowscale kernel takes [R, C] int8 "
                         f"codes, got {theta_q.dtype} {tuple(theta_q.shape)}")
    R, C = theta_q.shape
    for name, t, dt, shape in (
            ("theta_q", theta_q, torch.int8, (R, C)),
            ("i_fq", i_fq, F32, (R, C)), ("f_scale", f_scale, F32, (R,)),
            ("i_g", i_g, F32, (R, C))):
        if t.device != dev or t.dtype != dt or not t.is_contiguous() \
                or tuple(t.shape) != shape:
            raise ValueError(
                f"dampen_int8_rowscale kernel operand {name} must be a "
                f"contiguous {dt} tensor of shape {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    out = torch.empty_like(theta_q)
    if theta_q.numel():
        rows, blocks = rowscale_plan(
            R, C, (theta_q.data_ptr(), i_fq.data_ptr(), f_scale.data_ptr(),
                   i_g.data_ptr(), out.data_ptr()), PART_LIMIT)
        fn = getattr(_lib(), _ENTRY_ROWSCALE)
        with torch.cuda.device(dev):
            err = fn(rows.ctypes.data, len(rows), blocks, alpha, lam,
                     torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"dampen_int8_rowscale kernel launch failed: "
                               f"cudaError {err}")
        ROWSCALE_LAUNCHES += 1
    return out
