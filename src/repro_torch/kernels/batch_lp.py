"""The RGB batch 2-D LP kernel for Hopper: wrapper, plain version, geometry.

``rgb_cuda`` launches the hand-written CUDA C++ kernel in
``csrc/batch_lp.cu`` (built at first use by :mod:`._build`, loaded with
ctypes).  It replaces the TPU kernel
``src/repro/kernels/batch_lp.py::_rgb_kernel`` (launcher ``rgb_pallas``)
and keeps its contract: packed constraints ``L (B, 4, m_pad)`` with rows
``(a_x, a_y, b, 0)``, ``c (B, 2)``, ``m_valid (B, 1) int32`` in;
``x (B, 2)``, ``feas (B, 1) int32`` out; float32 and float64;
``B % tile == 0``, ``m_pad % LANE == 0``, ``m_pad % chunk == 0``.

What bounds the kernel on an H100: nominally bytes (each constraint is
read once, ~10 flops per constraint tested), in practice the incremental
dependency chain: the re-solves' instructions where many chains run at
once, one chain's latency where few do (``PERF.md``).  The design,
described at the top of the CUDA source: one warp per problem, 32
constraints tested per step by ballot, a re-solve that scans only the
warp-rounded prefix before the violated constraint, and — where
a problem's three used rows fit the block's shared memory — each problem
staged in shared memory by bulk asynchronous copies (the TMA) of its used
columns only, waited for chunk by chunk.  :func:`launch_geometry` sizes
the launch from shared memory: warps per CTA, dynamic shared-memory bytes,
and whether the problem is staged at all (wider problems read global
memory: the unstaged regime).  The kernel's result does not depend on
``chunk``, the tile or the regime, and nor does its work on ``chunk``:
the wrapper validates ``chunk`` only because it is the reference's
contract and the plain version's parameter.

``rgb_plain`` is the same function in plain PyTorch ops (closed-form box
faces like the kernel; its results equal the kernel's, though where +0
and -0 tie in a re-solve's min or max a zero's sign may differ).  The
tests use it, ``chip_smoke.py`` holds the kernel against it on the card,
and the wrapper takes it for a tensor that lies on the CPU — and only
then: for a CUDA tensor ``rgb_cuda`` launches the kernel or raises.
``rgb_cuda.launches`` counts kernel launches.

``rgb_cuda`` calls the operator ``torch.ops.repro_torch.rgb``, so the
dispatcher sees the kernel as one op: the CUDA implementation launches
it, the CPU one runs ``rgb_plain``, and the fake (``meta``) one gives
the outputs' shapes, which lets a dry run on ``meta`` tensors count the
kernel (its bytes, and its FLOPs by the formula registered below).

``prep_cuda`` and ``finish_cuda`` launch the solver front end's two passes
around the kernel, from the same library: one normalises, packs and pads a
batch into the kernel's arrays, the other computes the objective and the
flags.  The solver takes them for the kernel backend on the card; their
plain version is its eager front end (``solver/solver.py``).
:class:`FusedLaunch` binds the three launches of one solve shape once, for
the solver's launch plans: a call from a plan enqueues them through the
ctypes entry points, with no checks and no operator dispatch.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import NamedTuple, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.core import oneD
from repro_torch.core.lp import NORM_EPS

# Constraint counts are padded to a multiple of LANE.  The number is the
# reference's (its TPU lane width); the port keeps it so identical padded
# arrays feed both packages and the serving ladder is the same.
LANE = 128

# Most warps in one CTA (the kernel's launch bound).  Each warp solves one
# problem at a time, so a CTA of this many warps takes a tile of this many
# problems in one pass.  Wide problems get fewer warps: see
# ``launch_geometry``.
WARPS_PER_CTA = 8

# Problems per CTA when nothing says otherwise: one per warp of a full CTA.
DEFAULT_TILE = WARPS_PER_CTA

# Dynamic shared memory one block may opt in to on Hopper (H100, H200).
SMEM_PER_BLOCK = 232_448
# mbarriers (one completion point per column chunk) in a staging region;
# each is 8 bytes.  Must equal CHUNKS in csrc/batch_lp.cu.
CHUNKS = 8


class LaunchGeometry(NamedTuple):
    """How ``rgb_cuda`` launches the kernel for one shape."""
    warps: int        # warps per CTA
    smem_bytes: int   # dynamic shared memory per CTA
    staged: bool      # problems staged in shared memory (else global)


def region_bytes(m_pad: int, itemsize: int) -> int:
    """Shared memory of one staging region: rows 0-2 of one problem at
    full padded width, and its chunk barriers."""
    return 3 * m_pad * itemsize + CHUNKS * 8


def max_staged_m_pad(itemsize: int) -> int:
    """The widest ``m_pad`` (a multiple of ``LANE``) whose problem one
    warp can stage: 19,328 in float32, 9,600 in float64."""
    return (SMEM_PER_BLOCK - CHUNKS * 8) // (3 * itemsize) // LANE * LANE


def launch_geometry(m_pad: int, itemsize: int, tile: int) -> LaunchGeometry:
    """Warps per CTA, shared-memory bytes and regime for a launch at
    ``m_pad`` columns of ``itemsize`` bytes and ``tile`` problems per CTA.
    Pure arithmetic; no card is asked.

    * A problem is staged when one region fits the block's
      ``SMEM_PER_BLOCK``; otherwise the kernel reads global memory (no
      shared memory).
    * Warps: ``min(tile, WARPS_PER_CTA)``, and staged, no more than one
      region each lets fit in ``SMEM_PER_BLOCK``.  A warp walks its
      tile's problems one after another in its one region.
    """
    if m_pad < 0 or itemsize <= 0 or tile < 1:
        raise ValueError(
            f"bad geometry query m_pad={m_pad} itemsize={itemsize} "
            f"tile={tile}")
    warps = min(tile, WARPS_PER_CTA)
    region = region_bytes(m_pad, itemsize)
    if region > SMEM_PER_BLOCK:
        return LaunchGeometry(warps, 0, False)
    warps = min(warps, SMEM_PER_BLOCK // region)
    return LaunchGeometry(warps, warps * region, True)


def _pick_tile(batch: Optional[int] = None) -> int:
    """Problems per CTA for the Hopper kernel.

    Neither the problems' width nor their element size enters: a CTA's
    warps walk its tile one problem each at a time, and
    :func:`launch_geometry` fits the warps (and their staging regions) to
    the shared memory for whatever tile is asked.  What the tile does
    decide:

    * a CTA holds its shared memory until its slowest warp is done with
      ``tile / warps`` problems, and the card wants many more CTAs than
      its 132 SMs hold at once to even that out — small tiles win;
    * the batch is padded up to a multiple of the tile with neutral
      problems — small tiles waste fewer rows;
    * below one problem per warp the CTA's other warps idle.

    So: one problem per warp of a full CTA (``DEFAULT_TILE``), clamped to
    the batch when that is smaller.
    """
    t = DEFAULT_TILE
    if batch is not None:
        t = min(t, max(1, batch))
    return t


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _plain_tile(ax, ay, bb, c, mv, *, M, chunk, stats=None):
    """One tile of the plain version: ax/ay/bb (T, m_pad), c (T, 2),
    mv (T, 1).  Per-problem scalars are kept (T, 1)."""
    T, m_pad = ax.shape
    dt, dev = ax.dtype, ax.device
    cx, cy = c[:, 0:1], c[:, 1:2]
    cpx, cpy = -cy, cx        # perpendicular (tie-break) objective
    big = torch.finfo(dt).max
    x = torch.cat([oneD.sign_tie_break(cx, cpx) * M,
                   oneD.sign_tie_break(cy, cpy) * M], dim=1)  # (T, 2)
    feas = torch.ones((T, 1), dtype=torch.bool, device=dev)
    if T == 0:
        return x, feas
    h_iota = torch.arange(m_pad, device=dev)[None, :]
    max_mv = min(int(mv.max()), m_pad)

    for i in range(max_mv):
        a_ix, a_iy, b_i = ax[:, i:i + 1], ay[:, i:i + 1], bb[:, i:i + 1]
        lhs = a_ix * x[:, 0:1] + a_iy * x[:, 1:2]
        violated = feas & (i < mv) & (lhs > b_i + oneD.EPS_FEAS)  # (T, 1)
        if not bool(violated.any()):
            continue
        if stats is not None:
            n = int(violated.sum())
            stats["resolves"] = stats.get("resolves", 0) + n
            stats["resolve_work"] = stats.get("resolve_work", 0) + n * i
        # Line frame: p0 = a_i * b_i (unit normals), u = perp(a_i).
        p0x, p0y = a_ix * b_i, a_iy * b_i
        ux, uy = -a_iy, a_ix
        # sigma bounds over prior constraints h < i (paper eqs. 3-4).
        limit = -(-i // chunk) * chunk if chunk else m_pad
        axc, ayc, bbc = ax[:, :limit], ay[:, :limit], bb[:, :limit]
        denom = axc * ux + ayc * uy
        num = bbc - (axc * p0x + ayc * p0y)
        is_par = denom.abs() <= oneD.EPS_DENOM
        t = num / torch.where(is_par, 1.0, denom)  # guarded divide
        mask = h_iota[:, :limit] < i
        hi = torch.where(mask & (denom > oneD.EPS_DENOM), t, big)
        lo = torch.where(mask & (denom < -oneD.EPS_DENOM), t, -big)
        par_bad = (mask & is_par & (num < -oneD.EPS_FEAS)).any(
            dim=1, keepdim=True)
        if limit:
            t_lo = lo.amax(dim=1, keepdim=True)
            t_hi = hi.amin(dim=1, keepdim=True)
        else:   # i == 0 under chunking: no prior constraint to scan
            t_lo = torch.full((T, 1), -big, dtype=dt, device=dev)
            t_hi = torch.full((T, 1), big, dtype=dt, device=dev)
        # The four box bounds, in closed form.
        for bd, bn in ((ux, M - p0x), (-ux, M + p0x),
                       (uy, M - p0y), (-uy, M + p0y)):
            q = bn / torch.where(bd.abs() > oneD.EPS_DENOM, bd, 1.0)
            t_hi = torch.minimum(
                t_hi, torch.where(bd > oneD.EPS_DENOM, q, big))
            t_lo = torch.maximum(
                t_lo, torch.where(bd < -oneD.EPS_DENOM, q, -big))
            par_bad = par_bad | (
                (bd.abs() <= oneD.EPS_DENOM) & (bn < -oneD.EPS_FEAS))
        feas_new = (t_lo <= t_hi + oneD.EPS_FEAS) & ~par_bad
        # Objective endpoint selection (tie -> perpendicular objective).
        cu = cx * ux + cy * uy
        cpu = cpx * ux + cpy * uy
        pick_hi = torch.where(cu.abs() > oneD.EPS_TIE, cu > 0.0, cpu > 0.0)
        tt = torch.where(pick_hi, t_hi, t_lo)
        x_new = torch.cat([p0x + tt * ux, p0y + tt * uy], dim=1)
        x = torch.where(violated, x_new, x)
        feas = torch.where(violated, feas & feas_new, feas)
    return x, feas


def _check_launch(L, c, m_valid, tile, chunk):
    """Shared launcher contract: the reference's three ``ValueError``s
    plus shape/dtype sanity.  Returns ``(B, m_pad, tile)``."""
    if L.ndim != 3 or L.shape[1] != 4:
        raise ValueError(f"L must be (B, 4, m_pad), got {tuple(L.shape)}")
    B, _, m_pad = L.shape
    if L.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"L must be float32 or float64, got {L.dtype}")
    if c.shape != (B, 2) or c.dtype != L.dtype:
        raise ValueError(
            f"c must be ({B}, 2) {L.dtype}, got {tuple(c.shape)} {c.dtype}")
    if m_valid.shape != (B, 1) or m_valid.dtype != torch.int32:
        raise ValueError(
            f"m_valid must be ({B}, 1) int32, got {tuple(m_valid.shape)} "
            f"{m_valid.dtype}")
    if c.device != L.device or m_valid.device != L.device:
        raise ValueError(
            f"L, c and m_valid must share a device, got {L.device}, "
            f"{c.device}, {m_valid.device}")
    T = tile or _pick_tile(B)
    if T < 1:
        raise ValueError(f"tile {T} < 1")
    if B % T:
        raise ValueError(f"batch {B} not a multiple of tile {T}")
    if m_pad % LANE:
        raise ValueError(f"m_pad {m_pad} not a multiple of {LANE}")
    if chunk < 0:
        raise ValueError(f"chunk {chunk} < 0")
    if chunk and m_pad % chunk:
        raise ValueError(f"m_pad {m_pad} % chunk {chunk} != 0")
    return B, m_pad, T


def rgb_plain(
    L: torch.Tensor,        # (B, 4, m_pad) packed constraints, unit normals
    c: torch.Tensor,        # (B, 2)
    m_valid: torch.Tensor,  # (B, 1) int32
    *,
    M: float,
    tile: Optional[int] = None,
    chunk: int = 0,         # 0 = dense re-solve; >0 = chunked O(i) re-solve
    stats: Optional[dict] = None,
):
    """The kernel's function in plain PyTorch ops, on whatever device the
    tensors lie: ``(x (B, 2), feas (B, 1) int32)``.  Tiles are walked in
    a Python loop; within a tile the re-solve is skipped when no problem
    is violated (a host ``if``).  Per-problem results do not depend on
    ``tile``.  ``stats``, when given, accumulates ``resolves`` (re-solves
    taken) and ``resolve_work`` (prior constraints they had to scan) —
    the data-dependent work the kernel's roofline bound counts."""
    B, m_pad, T = _check_launch(L, c, m_valid, tile, chunk)
    M = float(M)
    xs, fs = [], []
    for lo in range(0, B, T):
        x, feas = _plain_tile(L[lo:lo + T, 0, :], L[lo:lo + T, 1, :],
                              L[lo:lo + T, 2, :], c[lo:lo + T],
                              m_valid[lo:lo + T], M=M, chunk=chunk,
                              stats=stats)
        xs.append(x)
        fs.append(feas)
    if not xs:
        return (torch.zeros((0, 2), dtype=L.dtype, device=L.device),
                torch.zeros((0, 1), dtype=torch.int32, device=L.device))
    return torch.cat(xs), torch.cat(fs).to(torch.int32)


# ---------------------------------------------------------------------------
# The CUDA kernel's wrapper
# ---------------------------------------------------------------------------

_launch_lock = threading.Lock()
_bound = {}

# The library's entry points, each for float32 (``<name>_launch_f32``) and
# float64 (``_f64``), and their argument types: pointers and the stream
# travel as 64-bit values.
_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRIES = {
    "rgb": [_P] * 5 + [_I] * 3 + [ctypes.c_double] + [_I] * 3 + [_P],
    "prep": [_P] * 7 + [_I] * 6 + [ctypes.c_double, _P],
    "finish": [_P] * 5 + [_I, _P],
}


def _launcher(name: str, dtype: torch.dtype):
    """The ctypes entry point ``name`` (``"rgb"``, ``"prep"`` or
    ``"finish"``) for ``dtype``; builds the library and binds every entry
    point at first use."""
    fn = _bound.get((name, dtype))
    if fn is not None:
        return fn
    from repro_torch.kernels import _build
    lib = _build.load("batch_lp")
    for entry, argtypes in _ENTRIES.items():
        for suffix, dt in (("f32", torch.float32), ("f64", torch.float64)):
            f = getattr(lib, f"{entry}_launch_{suffix}")
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            _bound[(entry, dt)] = f
    lib.rgb_error_string.argtypes = [ctypes.c_int]
    lib.rgb_error_string.restype = ctypes.c_char_p
    _bound["error_string"] = lib.rgb_error_string
    return _bound[(name, dtype)]


def _check_cuda(name: str, dtype: torch.dtype, device: torch.device,
                **tensors) -> None:
    """What every launch of the library needs: a card, float32 or
    float64, and each of ``tensors`` contiguous on ``device``."""
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: float32 or float64, got {dtype}")
    for key, t in tensors.items():
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous on {device}")


def _refused(name: str, code: int) -> RuntimeError:
    """The error of a launch of ``name`` the library refused with
    ``code`` (as ``<name>_cuda``, its wrapper, reports it)."""
    msg = _bound["error_string"](code).decode(errors="replace")
    return RuntimeError(f"{name}_cuda: launch refused (cuda error "
                        f"{code}: {msg})")


def _enqueue(name: str, dtype: torch.dtype, device: torch.device,
             *args) -> None:
    """Launch the entry point ``name`` for ``dtype`` with ``args`` on
    PyTorch's current stream of ``device``, without synchronising; a
    refused launch raises (as ``<name>_cuda``, its wrapper)."""
    fn = _launcher(name, dtype)
    with torch.cuda.device(device):
        code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        raise _refused(name, code)


def rgb_cuda(
    L: torch.Tensor,        # (B, 4, m_pad) packed constraints, unit normals
    c: torch.Tensor,        # (B, 2)
    m_valid: torch.Tensor,  # (B, 1) int32
    *,
    M: float,
    tile: Optional[int] = None,
    chunk: int = 0,         # the reference's re-solve width; see below
):
    """Launch the RGB kernel: ``(x (B, 2), feas (B, 1) int32)``.

    ``B`` must be a multiple of the tile and ``m_pad`` a multiple of
    ``LANE`` (``solver._solve_kernel`` pads both).  ``chunk`` is validated
    as the reference validates it and passed to the plain version; the
    kernel's re-solve always scans the warp-rounded prefix before the
    violated constraint, which gives the same result as any ``chunk``.
    On CUDA tensors the kernel is enqueued on PyTorch's current stream of
    the tensors' device, without synchronising; a refused launch or
    shared-memory opt-in raises.  On CPU tensors — and only there — the
    plain version runs instead.
    """
    _, _, T = _check_launch(L, c, m_valid, tile, chunk)
    return torch.ops.repro_torch.rgb(L, c, m_valid, float(M), T, chunk)


@torch.library.custom_op("repro_torch::rgb", mutates_args=(),
                         device_types="cuda")
def _rgb_op(L: torch.Tensor, c: torch.Tensor, m_valid: torch.Tensor,
            M: float, tile: int, chunk: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's launch on checked CUDA tensors."""
    return _launch(L, c, m_valid, M, tile,
                   launch_geometry(L.shape[2], L.element_size(), tile))


@_rgb_op.register_kernel("cpu")
def _rgb_op_cpu(L, c, m_valid, M, tile, chunk):
    return rgb_plain(L, c, m_valid, M=M, tile=tile, chunk=chunk)


@_rgb_op.register_fake
def _rgb_op_fake(L, c, m_valid, M, tile, chunk):
    B, _, _ = _check_launch(L, c, m_valid, tile, chunk)
    return (L.new_empty((B, 2)),
            L.new_empty((B, 1), dtype=torch.int32))


def rgb_flops(B: int, m: int) -> float:
    """The reference dry run's estimate of one batch's work
    (``src/repro/launch/dryrun.py::dryrun_lp``): ~4 FLOPs a constraint
    tested, and an expected ``2 ln m`` re-solves of ~12 m FLOPs each, a
    problem."""
    return B * (4.0 * m + 2 * math.log(max(m, 2)) * 12 * m)


@register_flop_formula(torch.ops.repro_torch.rgb)
def _rgb_flop_formula(L_shape, *args, **kwargs) -> int:
    return int(rgb_flops(L_shape[0], L_shape[2]))


def _launch(L, c, m_valid, M: float, tile: int, g: LaunchGeometry):
    """Enqueue the kernel at geometry ``g`` on checked CUDA tensors.
    ``rgb_cuda`` passes :func:`launch_geometry`'s pick; measurement
    scripts and tests may pass the unstaged regime at a shape that would
    be staged, which gives the same bits."""
    B, _, m_pad = L.shape
    _check_cuda("rgb_cuda", L.dtype, L.device, L=L, c=c, m_valid=m_valid)
    if L.data_ptr() % 16:
        raise ValueError("rgb_cuda: L must be 16-byte aligned (bulk copies)")
    x = torch.empty((B, 2), dtype=L.dtype, device=L.device)
    feas = torch.empty((B, 1), dtype=torch.int32, device=L.device)
    if B == 0:
        return x, feas
    try:
        _enqueue("rgb", L.dtype, L.device, L.data_ptr(), c.data_ptr(),
                 m_valid.data_ptr(), x.data_ptr(), feas.data_ptr(), B,
                 m_pad, tile, float(M), g.warps, int(g.staged),
                 g.smem_bytes)
    except RuntimeError as e:
        raise _rgb_refused(e, B, m_pad, tile, L.dtype, g) from None
    _count_rgb((B, m_pad, str(L.dtype).removeprefix("torch."), tile))
    return x, feas


def _rgb_refused(e: RuntimeError, B: int, m_pad: int, tile: int,
                 dtype: torch.dtype, g: LaunchGeometry) -> RuntimeError:
    return RuntimeError(f"{e} for B={B} m_pad={m_pad} tile={tile} "
                        f"{dtype} {g}")


def _count_rgb(key) -> None:
    with _launch_lock:
        rgb_cuda.launches += 1
        rgb_cuda.geometries[key] = rgb_cuda.geometries.get(key, 0) + 1


# Kernel launches made by this process (plain-version calls do not count):
# in all, and by ``(B, m_pad, dtype, tile)``.
rgb_cuda.launches = 0
rgb_cuda.geometries = {}


# ---------------------------------------------------------------------------
# The solver front end's passes around the kernel: prep and finish
# ---------------------------------------------------------------------------


def _check_prep(src, b, c, m_valid, *, m_pad: int, b_pad: int):
    """:func:`prep_cuda`'s checks, raising as it does: ``(B, m)``."""
    packed = b is None
    dt, dev = src.dtype, src.device
    extra = {} if packed else {"b": b}
    _check_cuda("prep_cuda", dt, dev, src=src, c=c, m_valid=m_valid, **extra)
    B = src.shape[0]
    m = src.shape[2] if packed else src.shape[1]
    want = (B, 4, m) if packed else (B, m, 2)
    if (tuple(src.shape) != want or (not packed and tuple(b.shape) != (B, m))
            or tuple(c.shape) != (B, 2) or m_valid.numel() != B
            or (not packed and b.dtype != dt) or c.dtype != dt
            or m_valid.dtype != torch.int32):
        raise ValueError(
            f"prep_cuda: want src {want}, b ({B}, {m}) and c ({B}, 2) "
            f"{dt}, m_valid {B} int32; got src {tuple(src.shape)}, b "
            f"{None if packed else (tuple(b.shape), b.dtype)}, c "
            f"{tuple(c.shape)} {c.dtype}, m_valid {tuple(m_valid.shape)} "
            f"{m_valid.dtype}")
    if m_pad < max(m, 1) or m_pad % LANE or b_pad < B:
        raise ValueError(f"prep_cuda: m_pad {m_pad} must be a positive "
                         f"multiple of {LANE} >= {m}, b_pad {b_pad} >= {B}")
    return B, m


def prep_cuda(src: torch.Tensor, b: Optional[torch.Tensor],
              c: torch.Tensor, m_valid: torch.Tensor, *, m_pad: int,
              b_pad: int, normalize: bool = True):
    """Normalise, pack and pad a batch in one launch: ``(L (b_pad, 4,
    m_pad), c (b_pad, 2), m_valid (b_pad, 1) int32)``, what ``rgb_cuda``
    takes.

    ``src`` is ``A (B, m, 2)`` with ``b (B, m)`` (the AoS layout), or the
    packed ``L (B, 4, m)`` with ``b=None``; ``c (B, 2)`` in the same
    dtype, ``m_valid`` ``B`` int32 counts; every tensor contiguous on one
    card.  ``m_pad`` (a positive multiple of ``LANE``, at least ``m``) and
    ``b_pad`` (at least ``B``) size the output.  The result equals, in
    every bit, the eager chain the solver runs elsewhere: ``pack``
    (AoS only), ``normalize_packed`` (when ``normalize``; the AoS
    ``normalize_batch`` computes the same), ``pad_packed`` to ``m_pad``,
    ``pad_packed_batch_dim`` to ``b_pad``.  That chain is this pass's plain
    version; there is no CPU mode.  ``prep_cuda.launches`` counts
    launches.
    """
    packed = b is None
    dt, dev = src.dtype, src.device
    B, m = _check_prep(src, b, c, m_valid, m_pad=m_pad, b_pad=b_pad)
    L = torch.empty((b_pad, 4, m_pad), dtype=dt, device=dev)
    c_out = torch.empty((b_pad, 2), dtype=dt, device=dev)
    mv_out = torch.empty((b_pad, 1), dtype=torch.int32, device=dev)
    _enqueue("prep", dt, dev, src.data_ptr(),
             None if packed else b.data_ptr(), c.data_ptr(),
             m_valid.data_ptr(), L.data_ptr(), c_out.data_ptr(),
             mv_out.data_ptr(), B, m, b_pad, m_pad, int(packed),
             int(normalize), NORM_EPS)
    with _launch_lock:
        prep_cuda.launches += 1
    return L, c_out, mv_out


def _check_finish(x, feas, c, batch: int) -> None:
    """:func:`finish_cuda`'s checks, raising as it does."""
    dt = x.dtype
    _check_cuda("finish_cuda", dt, x.device, x=x, feas=feas, c=c)
    if (x.ndim != 2 or x.shape[1] != 2 or tuple(c.shape) != tuple(x.shape)
            or c.dtype != dt or feas.dtype != torch.int32
            or feas.numel() != x.shape[0] or not 0 <= batch <= x.shape[0]):
        raise ValueError(
            f"finish_cuda: want x and c (n, 2) {dt}, feas n int32, batch "
            f"<= n; got x {tuple(x.shape)}, c {tuple(c.shape)} {c.dtype}, "
            f"feas {tuple(feas.shape)} {feas.dtype}, batch {batch}")


def finish_cuda(x: torch.Tensor, feas: torch.Tensor, c: torch.Tensor,
                batch: int):
    """The objective and the flags of the first ``batch`` problems, in one
    launch: ``(objective (batch,), feasible (batch,) bool)`` from what
    ``rgb_cuda`` wrote (``x (>= batch, 2)``, ``feas (>= batch, 1)``
    int32) and ``c`` (``>= batch`` rows, ``x``'s dtype); equal in bits to
    ``(c[:batch] * x[:batch]).sum(-1)`` and ``feas[:batch, 0].to(bool)``.
    ``finish_cuda.launches`` counts launches."""
    dt, dev = x.dtype, x.device
    _check_finish(x, feas, c, batch)
    obj = torch.empty((batch,), dtype=dt, device=dev)
    feasible = torch.empty((batch,), dtype=torch.bool, device=dev)
    _enqueue("finish", dt, dev, x.data_ptr(), feas.data_ptr(),
             c.data_ptr(), obj.data_ptr(), feasible.data_ptr(), batch)
    with _launch_lock:
        finish_cuda.launches += 1
    return obj, feasible


prep_cuda.launches = 0
finish_cuda.launches = 0


# ---------------------------------------------------------------------------
# The three launches of one solve shape, bound once
# ---------------------------------------------------------------------------


def current_card() -> int:
    """The index of the current card (CUDA initialised)."""
    return torch._C._cuda_getDevice()


def raw_stream(index: int) -> int:
    """The handle of PyTorch's current stream on card ``index``: what
    ``torch.cuda.current_stream(index).cuda_stream`` gives, without making
    a stream object."""
    return torch._C._cuda_getCurrentRawStream(index)


class FusedLaunch:
    """``prep``, ``rgb`` and ``finish`` for one solve shape on one card,
    bound once: what :func:`prep_cuda`, :func:`rgb_cuda` and
    :func:`finish_cuda` launch, with none of their checks, no operator
    dispatch and no device context or stream read of their own.

    The solver's launch plan (``solver/solver.py``) builds one after the
    first call of a shape has passed those checks, and hands each later
    call's tensors, which have the same shapes, dtype, device and
    contiguity, to its methods.  Each method enqueues one launch on
    ``stream`` (:func:`raw_stream`; the caller has made ``device``
    current), counts it as the wrapper does (``rgb_cuda.geometries``
    included), and raises a refused launch with the wrapper's message.

    What ``prep`` writes and ``rgb`` adds and ``finish`` reads (``L``,
    ``c``, ``m_valid`` and the flags) lies in one allocation a call, the
    *workspace*, which ``prep`` returns and :meth:`views` shows as the
    wrappers' tensors; ``x``, the objective and the flags returned are
    allocations of their own.  ``L`` starts the workspace (16-byte
    aligned, as the bulk copies need), and every other array starts at a
    multiple of its element size.
    """

    __slots__ = ("dtype", "device", "batch", "b_pad", "m_pad", "_prep",
                 "_rgb", "_finish", "_prep_args", "_rgb_args", "_rgb_key",
                 "_geometry", "_tile", "_offsets", "_bytes")

    def __init__(self, dtype: torch.dtype, device: torch.device, *,
                 batch: int, m: int, m_pad: int, b_pad: int, tile: int,
                 M: float, packed: bool, normalize: bool,
                 geometry: LaunchGeometry):
        self.dtype, self.device = dtype, device
        self.batch, self.b_pad, self.m_pad = batch, b_pad, m_pad
        self._prep = _launcher("prep", dtype)
        self._rgb = _launcher("rgb", dtype)
        self._finish = _launcher("finish", dtype)
        self._prep_args = (batch, m, b_pad, m_pad, int(packed),
                           int(normalize), NORM_EPS)
        self._rgb_args = (b_pad, m_pad, tile, float(M), geometry.warps,
                          int(geometry.staged), geometry.smem_bytes)
        self._rgb_key = (b_pad, m_pad, str(dtype).removeprefix("torch."),
                         tile)
        self._geometry, self._tile = geometry, tile
        item = dtype.itemsize
        c_at = b_pad * 4 * m_pad * item          # L (b_pad, 4, m_pad)
        mv_at = c_at + b_pad * 2 * item           # c (b_pad, 2)
        feas_at = mv_at + b_pad * 4               # m_valid (b_pad, 1)
        self._offsets = (c_at, mv_at, feas_at)
        self._bytes = feas_at + b_pad * 4         # feas (b_pad, 1)

    def views(self, ws: torch.Tensor):
        """``(L, c, m_valid, feas)`` in the workspace ``ws``, as the
        wrappers' tensors (for their checks)."""
        c_at, mv_at, feas_at = self._offsets
        n, dt = self.b_pad, self.dtype
        return (ws[:c_at].view(dt).view(n, 4, self.m_pad),
                ws[c_at:mv_at].view(dt).view(n, 2),
                ws[mv_at:feas_at].view(torch.int32).view(n, 1),
                ws[feas_at:].view(torch.int32).view(n, 1))

    def prep(self, src: torch.Tensor, b: Optional[torch.Tensor],
             c: torch.Tensor, m_valid: torch.Tensor,
             stream: int) -> torch.Tensor:
        """:func:`prep_cuda`'s ``L``, ``c`` and ``m_valid``, written into a
        new workspace, which it returns."""
        ws = torch.empty((self._bytes,), dtype=torch.uint8,
                         device=self.device)
        at = ws.data_ptr()
        c_at, mv_at, _ = self._offsets
        code = self._prep(src.data_ptr(),
                          None if b is None else b.data_ptr(),
                          c.data_ptr(), m_valid.data_ptr(), at, at + c_at,
                          at + mv_at, *self._prep_args, stream)
        if code:
            raise _refused("prep", code)
        with _launch_lock:
            prep_cuda.launches += 1
        return ws

    def rgb(self, ws: torch.Tensor, stream: int) -> torch.Tensor:
        """:func:`rgb_cuda` on the workspace: ``x``; its flags go to the
        workspace."""
        n = self.b_pad
        x = torch.empty((n, 2), dtype=self.dtype, device=self.device)
        at = ws.data_ptr()
        c_at, mv_at, feas_at = self._offsets
        code = self._rgb(at, at + c_at, at + mv_at, x.data_ptr(),
                         at + feas_at, *self._rgb_args, stream)
        if code:
            raise _rgb_refused(_refused("rgb", code), n, self.m_pad,
                               self._tile, self.dtype, self._geometry)
        _count_rgb(self._rgb_key)
        return x

    def finish(self, x: torch.Tensor, ws: torch.Tensor, stream: int):
        """:func:`finish_cuda`'s ``(objective, feasible)``."""
        dt, dev, n = self.dtype, self.device, self.batch
        obj = torch.empty((n,), dtype=dt, device=dev)
        feasible = torch.empty((n,), dtype=torch.bool, device=dev)
        at = ws.data_ptr()
        c_at, _, feas_at = self._offsets
        code = self._finish(x.data_ptr(), at + feas_at, at + c_at,
                            obj.data_ptr(), feasible.data_ptr(), n, stream)
        if code:
            raise _refused("finish", code)
        with _launch_lock:
            finish_cuda.launches += 1
        return obj, feasible
