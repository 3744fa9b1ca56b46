"""PSF convolution with the supersample pool folded in, as a direct strided
sum: the CUDA kernel (K4's direct route) and its plain versions.

Computes the same function as :mod:`gigalens_tpu.ops.pallas.dft_conv` (a
'SAME' convolution with the flipped kernel followed by a p x p mean pool),
by another algorithm. Per sample,

    out[i, j] = sum_{s, t} w[s, t] * x[p*i + s - oy, p*j + t - ox]

with x zero outside the image, ``oy = kh - 1 - kh // 2`` (likewise ``ox``)
and ``w`` the flipped PSF summed over the p x p pool box and divided by
p^2, of size (kh + p - 1, kw + p - 1). Both directions split into p^2
dense stride-1 correlations with ceil((kh + p - 1) / p)-tap sub-kernels of
``w`` (:func:`forward_phases`, :func:`transpose_phases`): the forward sums
them over the p^2 polyphase components x[p*m + b, p*n + b'] of the image,
the transpose (VJP),

    g[m, n] = sum_{i, j} ct[i, j] * w[m + oy - p*i, n + ox - p*j],

writes one to each (m mod p, n mod p) phase of its output. One kernel
(``csrc/direct_conv.cu``) computes both.

:func:`direct_conv_reference` and :func:`direct_conv_transpose_reference`
are the plain versions, written as explicit tap sums; the wrappers take them
for CPU tensors only. :func:`k4_route` is the shape rule that sends a
``PSFConv`` on the card to this kernel (the smaller PSFs) or to the
half-spectrum DFT chain.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from gigalens_tpu_torch.ops.cuda import _build
from gigalens_tpu_torch.ops.cuda.dft_conv import chain_macs
from gigalens_tpu_torch.utils.profiling import span

# Launch counts per direction; each wrapper adds one where it launches.
launches = {"direct_conv_fwd": 0, "direct_conv_transpose": 0}

# Launch plans (:func:`plan`). A thread holds R rows x C columns of
# outputs, (R, C) one of VARIANTS (a compiled variant each: the 5-row tiles,
# then the thin tile for grids too small to fill the card); a block holds at
# most MAX_THREADS threads and MAX_LANES column lanes.
VARIANTS, THIN, MAX_THREADS, MAX_LANES = ((5, 5), (5, 3), (5, 2), (2, 2)), (2, 2), 256, 32
# A 5-row tile's cost a live output: 1 + REUSE_COST * (shared loads / FMAs),
# (4 + R) / (4 R C). With it the plan came within 12% of the fastest tile
# choice at every shape the port launches (within 8% but at the cluster
# MAP's forward; scripts/torch_k4_ab.py --sweep on an H100); tiny batches of
# ragged shapes, which no path launches, lose up to 2.2x.
REUSE_COST = 2.0
PAD_ROWS = 4  # zero rows above and below each sub-kernel in the kernel's weights
MAX_STAGES = 4  # halo buffers of the ring (the kernel's cp.async.wait_group immediates)
TMA_BOX = 256  # the most elements a TMA box spans along a dimension
# The card: 132 SMs. A plan cuts the grid to at least two blocks an SM
# (MIN_BLOCKS) where tiles stay mostly live (MIN_LIVE of the outputs a
# tile's threads hold are the function's), and takes THIN where a 5-row
# tile's grid leaves SMs idle.
SMS, MIN_BLOCKS, MIN_LIVE = 132, 264, 0.75
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on sm_90
SMEM_SM = 233_472  # bytes an SM holds for its blocks, 1 KB of each reserved
# registers a thread at most, by thread tile (the kernel's __maxnreg__: the
# fewest at which ptxas spills nothing for the 5x5 tile, three blocks of 256
# threads an SM for the other 5-row tiles, four for THIN)
REGS = {(5, 5): 88, (5, 3): 80, (5, 2): 80, (2, 2): 64}
# A block of fewer than 4 warps of the widest tile is never planned for
# the route's fit: at 2 warps the forward took twice its 4-warp time (13.1
# against 6.1 ms around 176 px on an H100 at bs 500, 160x160;
# scripts/torch_k4_routes.py).
MIN_FIT_WARPS = 4


def offsets(kh: int, kw: int):
    """(oy, ox): the first image row/column a tap of ``w`` reaches."""
    return kh - 1 - kh // 2, kw - 1 - kw // 2


def pooled_kernel(kernel, pool: int) -> np.ndarray:
    """The flipped kernel summed over the pool box, / pool^2 (float64)."""
    k = np.asarray(kernel, np.float64)[::-1, ::-1]
    kh, kw = k.shape
    w = np.zeros((kh + pool - 1, kw + pool - 1))
    for di in range(pool):
        for dj in range(pool):
            w[di:di + kh, dj:dj + kw] += k
    return w / pool**2


def _take(w, s, t):
    """w[s][:, t] for index vectors s and t, zero past w's edges."""
    ok = (s[:, None] < w.shape[0]) & (t[None, :] < w.shape[1])
    return np.where(ok, w[np.minimum(s, w.shape[0] - 1)][:, np.minimum(t, w.shape[1] - 1)], 0.0)


def forward_phases(w: np.ndarray, pool: int, oy: int, ox: int):
    """The forward's p^2 stride-1 correlations, one per polyphase component
    of the image: sub-kernels (p^2, ku, kv), w[p*u + a, p*v + b] for tap
    phase (a, b), and per-phase (oy, ox, by, bx, ry, rx) = (offsets, the
    component's row/column phase, the output's: 0)."""
    p = pool
    u, v = np.arange(-(-w.shape[0] // p)), np.arange(-(-w.shape[1] // p))
    subs, table = [], []
    for a in range(p):
        al, by = divmod(a - oy, p)  # x row p*(i + u + al) + by
        for b in range(p):
            ac, bx = divmod(b - ox, p)
            subs.append(_take(w, p * u + a, p * v + b))
            table.append((-al, -ac, by, bx, 0, 0))
    return np.stack(subs), np.asarray(table, np.int32)


def transpose_phases(w: np.ndarray, pool: int, oy: int, ox: int):
    """The transpose's p^2 stride-1 correlations of the cotangent, one per
    output phase: sub-kernels (p^2, ku, kv) and per-phase (oy, ox, by, bx,
    ry, rx) = (offsets, the input's row/column phase: 0, the output's)."""
    p = pool
    ku, kv = -(-w.shape[0] // p), -(-w.shape[1] // p)
    subs, table = [], []
    for rm in range(p):
        cq, cr = divmod(rm + oy, p)
        for rn in range(p):
            dq, dr = divmod(rn + ox, p)
            # sub-kernel row u reads tap row p*(ku - 1 - u) + cr (flipped)
            subs.append(_take(w, p * (ku - 1 - np.arange(ku)) + cr,
                              p * (kv - 1 - np.arange(kv)) + dr))
            table.append((ku - 1 - cq, kv - 1 - dq, 0, 0, rm, rn))
    return np.stack(subs), np.asarray(table, np.int32)


def _tap_sum(x, w, stride, oy, ox, oh, ow):
    """sum_{s,t} w[s,t] x[stride*i + s - oy, stride*j + t - ox] -> (n, oh, ow)."""
    n, h, wd = x.shape
    kh, kw = w.shape
    lo_y, lo_x = max(oy, 0), max(ox, 0)
    hi_y = max(stride * (oh - 1) + kh - 1 - oy - (h - 1), 0)
    hi_x = max(stride * (ow - 1) + kw - 1 - ox - (wd - 1), 0)
    xp = F.pad(x, (lo_x, hi_x, lo_y, hi_y))
    by, bx = lo_y - oy, lo_x - ox
    out = torch.zeros((n, oh, ow), dtype=x.dtype, device=x.device)
    for s in range(kh):
        for t in range(kw):
            r0, c0 = by + s, bx + t
            out += w[s, t] * xp[:, r0:r0 + stride * (oh - 1) + 1:stride,
                                c0:c0 + stride * (ow - 1) + 1:stride]
    return out


def direct_conv_reference(x, w, pool: int, oy: int, ox: int):
    """Plain forward: (n, H, W) -> (n, H/p, W/p), explicit tap sums."""
    return _tap_sum(x, w, pool, oy, ox, x.shape[1] // pool, x.shape[2] // pool)


def direct_conv_transpose_reference(ct, w, pool: int, oy: int, ox: int, h: int, wd: int):
    """Plain transpose: (n, H/p, W/p) -> (n, H, W), each tap's product
    scattered back to the input positions it read (the adjoint)."""
    n, oh, ow = ct.shape
    kh, kw = w.shape
    p = pool
    hi_y = max(p * (oh - 1) + kh - 1 - oy - (h - 1), 0)
    hi_x = max(p * (ow - 1) + kw - 1 - ox - (wd - 1), 0)
    g = torch.zeros((n, oy + h + hi_y, ox + wd + hi_x), dtype=ct.dtype, device=ct.device)
    for s in range(kh):
        for t in range(kw):
            g[:, s:s + p * (oh - 1) + 1:p, t:t + p * (ow - 1) + 1:p] += w[s, t] * ct
    return g[:, oy:oy + h, ox:ox + wd]


def by_tiles_reference(x, subs, table, pl, n_in: int, gather: int, out_stride: int,
                       oh: int, ow: int):
    """Either direction as the kernel's blocks compute it under the launch
    plan ``pl`` (:func:`plan`): for each output phase, block of ``spb``
    samples, column tile and row band, each load as the block takes it
    (``hh`` raw input rows ``gather`` apart from the first of its input
    phases' halo, ``pw`` raw columns from the multiple of 4 at or before
    the halo's first, zero past the image), each of the ``gather`` input
    phases it serves read every ``gather``-th column from its own offset, the tile's tap sums in the kernel's order (input phase,
    tap row, tap, over the sub-kernel's taps zero-padded to a multiple of
    4), and the tile's live rows and columns stored. Raises unless every
    output is written exactly once."""
    n, h, wd = x.shape
    R, C, g = pl["rows"], pl["cols"], gather
    th, tw = R * pl["rb"], C * pl["lx"]
    kh, kw = subs.shape[1:]
    kwp = _ceil(kw, 4) * 4
    hh, pw = pl["hh"], pl["pw"]
    if hh < th + kh - 1 or pw < g * (tw + kwp + 2) + 3:
        raise ValueError(f"the plan's loads {hh} x {pw} do not cover a {th} x {tw} tile")
    w = F.pad(subs, (0, kwp - kw))
    rows = table.tolist()
    out = torch.zeros((n, oh * out_stride, ow * out_stride), dtype=x.dtype, device=x.device)
    written = torch.zeros(out.shape, dtype=torch.int32)
    spb = pl["spb"]
    for ph in range(len(rows) // n_in):
        ry, rx = rows[ph * n_in][4:]
        for b0 in range(0, n, spb):
            xb = x[b0:b0 + spb]
            for tx in range(pl["tiles_x"]):
                for band in range(pl["bands"]):
                    i0, j0 = band * th, tx * tw
                    acc = torch.zeros((xb.shape[0], th, tw), dtype=x.dtype, device=x.device)
                    for u in range(n_in // g):
                        oy, ox, by, bx = rows[ph * n_in + u * g][:4]
                        gr = g * (i0 - oy) + by + g * torch.arange(hh)
                        c0 = g * (j0 - ox) + bx
                        gc = c0 // 4 * 4 + torch.arange(pw)
                        raw = xb[:, gr.clamp(0, h - 1)][:, :, gc.clamp(0, wd - 1)]
                        raw = raw * (((gr >= 0) & (gr < h))[:, None]
                                     & ((gc >= 0) & (gc < wd))[None, :])
                        for b in range(g):
                            halo = raw[:, :, c0 % 4 + b::g]
                            q = ph * n_in + u * g + b
                            for t in range(kh):
                                for v in range(kwp):
                                    acc += w[q, t, v] * halo[:, t:t + th, v:v + tw]
                    ni, nj = min(th, oh - i0), min(tw, ow - j0)
                    if ni <= 0 or nj <= 0:
                        continue
                    ri = (i0 + torch.arange(ni)) * out_stride + ry
                    cj = (j0 + torch.arange(nj)) * out_stride + rx
                    sel = (slice(b0, b0 + xb.shape[0]), ri[:, None], cj[None, :])
                    out[sel] = acc[:, :ni, :nj]
                    written[sel] += 1
    if not bool((written == 1).all()):
        raise AssertionError(f"the plan writes outputs {int(written.min())} to "
                             f"{int(written.max())} times, not once each")
    return out


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _sub_shape(kh, kw, pool):
    return _ceil(kh + pool - 1, pool), _ceil(kw + pool - 1, pool)


def _bank_cost(ldp, rows, cols, g, lx, rb, spb, sb, warps):
    """Shared-memory wavefronts of one window load by every warp of the
    block (words ``g`` apart along a raw row): per warp, the most lanes
    that land on one of the 32 banks."""
    cost = 0
    for w0 in range(0, 32 * warps, 32):
        banks = [0] * 32
        for t in range(w0, w0 + 32):
            s, rem = divmod(t, rb * lx)
            if s < spb:
                ly, lane = divmod(rem, lx)
                banks[(s * sb + rows * ly * ldp + g * cols * lane) % 32] += 1
        cost += max(banks)
    return cost


def _smem(n_in, ku, kvp, spb, sb, stages):
    """Bytes of dynamic shared memory: 128 for the mbarriers, the n_in
    sub-kernels between their zero rows (to 128 bytes), then ``stages`` halo
    buffers of ``spb`` samples x ``sb`` floats."""
    w = n_in * (ku + 2 * PAD_ROWS) * kvp
    return 128 + 4 * (_ceil(w, 32) * 32 + stages * spb * sb)


def _resident(smem, warps, rows, cols):
    """Blocks an SM holds at once, by shared memory, threads and registers."""
    if smem > SMEM_LIMIT:
        return 0
    regs = REGS[rows, cols]
    return min(SMEM_SM // (smem + 1024), 64 // warps, 65_536 // (regs * 32) // warps, 32)


def _geometry(bs, out_h, out_w, pool, direction, rows, cols):
    """(n_in, n_out, gather, in_w, tiles_x, lx, rs): input and output phases,
    the input's gather (also the input phases a load of raw rows serves)
    and row width, column tiles, column lanes and row lanes a sample of
    ``rows x cols`` thread tiles."""
    fwd = direction == "fwd"
    n_in, n_out, g = (pool * pool, 1, pool) if fwd else (1, pool * pool, 1)
    tiles_x = _ceil(out_w, MAX_LANES * cols)
    return (n_in, n_out, g, out_w * g, tiles_x, _ceil(out_w, cols * tiles_x),
            _ceil(out_h, rows))


def tile_choices(bs, out_h, out_w, ku, kv, pool, direction, rows, cols):
    """Every (rb, bands, spb) the kernel takes with ``rows x cols`` thread
    tiles whose one-buffer block fits in shared memory (bands of equal
    height; several samples a block only for whole samples), with its
    warps, grid size and live share."""
    n_in, n_out, g, _, tiles_x, lx, rs = _geometry(bs, out_h, out_w, pool, direction, rows,
                                                   cols)
    kvp = _ceil(kv, 4) * 4
    out = []
    for rb in range(1, rs + 1):
        bands = _ceil(rs, rb)
        if _ceil(rs, bands) != rb or rb * lx > MAX_THREADS:
            continue
        hh = rows * rb + ku - 1
        for spb in range(1, MAX_THREADS // (rb * lx) + 1 if bands == 1 else 2):
            if _smem(n_in, ku, kvp, spb, hh * (g * (cols * lx + kvp + 2) + 3), 1) > SMEM_LIMIT:
                break
            warps = _ceil(spb * rb * lx, 32)
            blocks = n_out * tiles_x * bands * _ceil(bs, spb)
            live = bs * n_out * out_h * out_w / (blocks * warps * 32 * rows * cols)
            out.append(dict(rb=rb, bands=bands, spb=spb, warps=warps, blocks=blocks, live=live))
    return out


def launch_plan(bs, out_h, out_w, ku, kv, pool, direction, rows, cols, rb, spb, stages=None,
                tma=None):
    """The launch plan of ``rows x cols`` thread tiles in bands of ``rb``
    row lanes with ``spb`` samples a block (see :func:`plan`). A load brings
    ``hh`` raw input rows ``gather`` apart and ``pw`` raw columns, which hold
    ``gather`` input phases (the forward's column phases); the loads come by
    TMA where the input rows are a multiple of 16 bytes and the box fits
    TMA_BOX elements a dimension (``tma`` False forces the 4-byte copies);
    ``stages`` load buffers, or where None the most that keep as many blocks
    an SM as one buffer does, or as the grid needs for one wave."""
    n_in, n_out, g, in_w, tiles_x, lx, rs = _geometry(bs, out_h, out_w, pool, direction, rows,
                                                      cols)
    kvp = _ceil(kv, 4) * 4
    n_ld = n_in // g
    bands = _ceil(rs, rb)
    if spb > 1 and bands > 1:
        raise ValueError("several samples a block only for whole samples (one band)")
    warps = _ceil(spb * rb * lx, 32)
    blocks = n_out * tiles_x * bands * _ceil(bs, spb)
    # the window's last loads reach 2 words past its taps; a load starts at
    # the 4-float boundary at or before the halo, up to 3 words early
    hh, pw = rows * rb + ku - 1, g * (cols * lx + kvp + 2) + 3
    pw4 = _ceil(pw, 4) * 4
    if tma is None:
        tma = in_w % 4 == 0 and pw4 <= TMA_BOX and g * hh <= TMA_BOX
    # TMA writes its box densely: the pitch is the box's width, a multiple
    # of 4 floats, each sample's buffer 128-byte aligned
    pitches = range(pw4, min(pw4 + 32, TMA_BOX + 1), 4) if tma else range(pw, pw + 32)

    def sb(ldp):
        return _ceil(hh * ldp, 32) * 32 if tma else _ceil(hh * ldp, 4) * 4

    ldp = min(pitches, key=lambda ldp: (
        _bank_cost(ldp, rows, cols, g, lx, rb, spb, sb(ldp), warps), ldp))
    if stages is None:
        one = _resident(_smem(n_in, ku, kvp, spb, sb(ldp), 1), warps, rows, cols)
        need = min(one, _ceil(blocks, SMS))
        for stages in sorted({min(n_ld, MAX_STAGES), min(n_ld, 2), 1}, reverse=True):
            if _resident(_smem(n_in, ku, kvp, spb, sb(ldp), stages), warps, rows, cols) >= need:
                break
    return dict(rows=rows, cols=cols, lx=lx, rb=rb, spb=spb, tiles_x=tiles_x, bands=bands,
                stages=stages, warps=warps, hh=hh, pw=pw, ldp=ldp, sb=sb(ldp), tma=int(tma),
                smem=_smem(n_in, ku, kvp, spb, sb(ldp), stages), blocks=blocks,
                live=bs * n_out * out_h * out_w / (blocks * warps * 32 * rows * cols))


def _tile_choice(bs, out_h, out_w, ku, kv, pool, direction, rows, cols):
    """The plan rule's tile for a thread tile (see :func:`plan`), or None."""
    cands = tile_choices(bs, out_h, out_w, ku, kv, pool, direction, rows, cols)
    if not cands:
        return None
    ok = [c for c in cands if c["live"] >= MIN_LIVE]
    if not ok:
        best = max(c["live"] for c in cands)
        ok = [c for c in cands if c["live"] == best]
    floor = min(MIN_BLOCKS, max(c["blocks"] for c in ok))
    return max((c for c in ok if c["blocks"] >= floor), key=lambda c: (c["live"], -c["blocks"]))


@functools.lru_cache(maxsize=None)
def plan(bs: int, out_h: int, out_w: int, ku: int, kv: int, pool: int, direction: str):
    """Launch plan of one direction of the kernel on ``bs`` samples of
    ``out_h x out_w`` output phases (``ku x kv`` sub-kernels, pool ``pool``),
    a pure function of these shapes (nothing is tried at run time), or None
    where no block fits in shared memory:

    * ``rb`` row lanes a band (a tile of rows * rb output rows), ``bands`` a
      sample, or ``spb`` whole samples packed into a block, for a thread
      tile: among the choices whose tiles are at least MIN_LIVE live
      (outputs of the function over outputs the launched threads hold), the
      most live of those with at least MIN_BLOCKS blocks (or, where none
      reaches it, the most blocks), then the fewest blocks;
    * ``rows x cols``: the 5-row thread tile whose choice scores best by live
      share over 1 + REUSE_COST x its shared loads a multiply-add, or THIN
      where that grid has fewer blocks than the card has SMs; ``lx`` column lanes
      (at most MAX_LANES) over ``tiles_x`` column tiles;
    * ``tma``, ``stages``: how the loads come, into how many buffers
      (:func:`launch_plan`);
    * ``hh`` / ``pw`` / ``ldp`` / ``sb``: raw rows and columns a load
      brings, its row pitch (the one with the fewest bank conflicts of the
      window loads) and floats a sample's buffer; ``smem`` bytes, ``warps``
      a block, ``blocks`` in the grid and ``live``.
    """
    best = None
    for rows, cols in VARIANTS:
        if (rows, cols) == THIN:
            continue
        c = _tile_choice(bs, out_h, out_w, ku, kv, pool, direction, rows, cols)
        if c is None:
            continue
        score = c["live"] / (1 + REUSE_COST * (4 + rows) / (4 * rows * cols))
        if best is None or score > best[0]:
            best = (score, rows, cols, c)
    if best is None:
        return None
    _, rows, cols, c = best
    if c["blocks"] < SMS:
        thin = _tile_choice(bs, out_h, out_w, ku, kv, pool, direction, *THIN)
        if thin is not None:
            (rows, cols), c = THIN, thin
    return launch_plan(bs, out_h, out_w, ku, kv, pool, direction, rows, cols, c["rb"], c["spb"])


def fits(ku: int, kv: int, pool: int) -> bool:
    """Whether both directions fit a block of MIN_FIT_WARPS warps of the
    widest tile (80 columns, 40 rows, one load buffer) in shared memory: the
    direct route's limit in ``k4_route`` (to 143 px at pool 2, where a
    forward load holds two column phases' raw rows)."""
    kvp = _ceil(kv, 4) * 4
    rb = MIN_FIT_WARPS * 32 // 16  # row lanes beside 16 column lanes of 5 columns
    hh = 5 * rb + ku - 1
    return all(
        _smem(n_in, ku, kvp, 1, _ceil(hh * _ceil(g * (80 + kvp + 2) + 3, 4) * 4, 32) * 32, 1)
        <= SMEM_LIMIT for n_in, g in ((pool * pool, pool), (1, 1)))


def direct_macs(h, w, kh, kw, pool) -> int:
    """Multiply-adds a sample of the direct sum, either direction: output
    pixels times the pooled kernel's taps."""
    return (h // pool) * (w // pool) * (kh + pool - 1) * (kw + pool - 1)


# T multiply-adds a second each K4 kernel sustains of what it executes, both
# directions together, on an H100 at bs 500, 160x160 (scripts/
# torch_k4_routes.py, 19 sizes of 51-121 px over two runs): the direct
# kernel 16.4-19.1, median 18.3; the chain 16.2-16.6 up to 91 px and
# 17.1-17.6 above (its tile count steps). The measured crossovers (direct
# faster at 79 and 103 px, the chain at 81 and 105) hold the ratio of the
# two rates in [1.059, 1.085): the chain's rate is taken there.
DIRECT_RATE, CHAIN_RATE = 18.3, 17.2


def k4_route(kh, kw, pool, h, w) -> str:
    """The K4 kernel for a (kh, kw) PSF on (h, w) images: "direct" where the
    direct sum's multiply-adds take no longer at DIRECT_RATE than those the
    half-spectrum DFT chain executes with its tiles take at CHAIN_RATE, both
    directions together (and only where both directions of the direct
    kernel fit a block of MIN_FIT_WARPS warps in shared memory, :func:`fits`,
    which holds to 175 px at pool 2), else "chain". A pure shape rule, nothing is tried at
    run time; the two rates are its measurement. On 160x160 images at pool 2
    it names the faster route at every size timed (51-121 px, where both
    were; the chain alone to 261 px): direct to 79 px and again at 93-103
    px, where the spectrum has just spilled into another tile of columns,
    the chain elsewhere."""
    ku, kv = _sub_shape(kh, kw, pool)
    chain = sum(chain_macs(h, w, kh, kw, pool, transpose=t, tiles=True) for t in (False, True))
    direct = 2 * direct_macs(h, w, kh, kw, pool)
    return "direct" if fits(ku, kv, pool) and direct / DIRECT_RATE <= chain / CHAIN_RATE else "chain"


# the plan's entries in the order the C entry points take them
PLAN_ARGS = ("rows", "cols", "lx", "rb", "spb", "tiles_x", "bands", "stages", "warps", "hh",
             "pw", "ldp", "sb", "tma", "smem")


def direct_conv_cuda(x, conv: "DirectConv", direction: str, pl=None):
    """Launches the kernel on x: (bs, H, W) forward or (bs, H/p, W/p)
    transpose, with the weights and phase table ``conv`` holds, under the
    launch plan ``pl`` (:func:`launch_plan`; by default :func:`plan`'s)."""
    pp = conv.pool * conv.pool
    bs = x.shape[0]
    if direction == "fwd":
        in_shape, out_shape = (conv.h, conv.w), (conv.out_h, conv.out_w)
        w, table = conv.w_fwd, conv.table_fwd
    else:
        in_shape, out_shape = (conv.out_h, conv.out_w), (conv.h, conv.w)
        w, table = conv.w_t, conv.table_t
    _build.check_arg(x, "x", (bs, *in_shape), x.device)
    _build.check_arg(w, "w", (pp, conv.ku + 2 * PAD_ROWS, _ceil(conv.kv, 4) * 4), x.device)
    _build.check_arg(table, "phase table", (pp, 6), x.device, dtype=torch.int32)
    pl = pl or conv.plan(bs, direction)
    if pl["tma"] and x.data_ptr() % 16:
        x = x.clone()  # a tensor map starts on a 16-byte boundary
    out = torch.empty((bs, *out_shape), dtype=torch.float32, device=x.device)
    lib, ptr = _build.load(), _build.ptr
    fn = lib.gl_direct_conv_fwd if direction == "fwd" else lib.gl_direct_conv_transpose
    # one kernel symbol serves both directions: the range names the direction
    # in a torch.profiler trace
    with torch.cuda.device(x.device), span(f"direct_conv_{direction}"):
        err = fn(ptr(x), ptr(out), ptr(w), ptr(table), bs, conv.h, conv.w, conv.pool, conv.ku,
                 conv.kv, *(pl[k] for k in PLAN_ARGS), _build.stream(x.device))
    _build.check(err, f"direct_conv ({direction})")
    launches[f"direct_conv_{direction}"] += 1
    return out


class _DirectConvFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, conv):
        ctx.conv = conv
        if x.device.type == "cpu":
            return direct_conv_reference(x, conv.w_ref, conv.pool, conv.oy, conv.ox)
        return direct_conv_cuda(x.contiguous(), conv, "fwd")

    @staticmethod
    def backward(ctx, ct):
        c = ctx.conv
        if ct.device.type == "cpu":
            return direct_conv_transpose_reference(ct, c.w_ref, c.pool, c.oy, c.ox,
                                                   c.h, c.w), None
        return direct_conv_cuda(ct.contiguous(), c, "transpose"), None


class DirectConv:
    """(bs, H, W) -> (bs, H/p, W/p): 'SAME' convolution with ``kernel`` and
    a p x p mean pool, as the direct strided sum. ``pool`` must divide the
    image. Differentiable: the backward is the transpose kernel (the map is
    linear, so nothing is saved). Weights are built once in float64 and
    kept as float32 on ``device``."""

    def __init__(self, kernel, img_shape, pool: int, device):
        kernel = np.asarray(kernel)
        kh, kw = kernel.shape
        self.h, self.w = int(img_shape[0]), int(img_shape[1])
        self.pool = p = int(pool)
        if self.h % p or self.w % p:
            raise ValueError("pool must divide the image shape")
        self.out_h, self.out_w = self.h // p, self.w // p
        self.oy, self.ox = offsets(kh, kw)
        w64 = pooled_kernel(kernel, p)
        device = torch.device(device)

        def f32(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)

        self.w_ref = f32(w64)  # (kh + p - 1, kw + p - 1): the plain versions' weights
        # the kernel's sub-kernels (p^2, ku, kv) between PAD_ROWS zero rows
        # above and below, zero taps to a multiple of 4, and phase tables (p^2, 6)
        subs, table = forward_phases(w64, p, self.oy, self.ox)
        self.ku, self.kv = subs.shape[1:]
        pad = ((0, 0), (PAD_ROWS, PAD_ROWS), (0, _ceil(self.kv, 4) * 4 - self.kv))
        self.w_fwd, self.table_fwd = f32(np.pad(subs, pad)), torch.as_tensor(table, device=device)
        subs, table = transpose_phases(w64, p, self.oy, self.ox)
        self.w_t, self.table_t = f32(np.pad(subs, pad)), torch.as_tensor(table, device=device)
        if device.type == "cuda" and not fits(self.ku, self.kv, p):
            raise ValueError(f"a {kh}x{kw} PSF at pool {p} does not fit the direct "
                             "kernel's shared memory; use the chain (k4_route)")

    def plan(self, bs: int, direction: str):
        """The launch plan of ``direction`` at ``bs`` samples (:func:`plan`)."""
        return plan(bs, self.out_h, self.out_w, self.ku, self.kv, self.pool, direction)

    def __call__(self, x):
        return _DirectConvFn.apply(x, self)
