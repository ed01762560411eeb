"""Pippenger multi-scalar multiplication (sort + prefix sums).

The port of ``groth_sahai_tpu/ops/msm.py``. The pipeline is the
reference's, step for step, so that the sorted streams and the kernels'
shapes are the same:

  1. slice the scalars into signed w-bit digits (digits in
     [-(2^(w-1) - 1), 2^(w-1)], the sign in bit 31 of the payload);
  2. per window, one stable sort of (digit, point index) pairs along the
     point axis (`torch.sort(..., stable=True)`, as `lax.sort` is stable),
     so the window-major key stream is globally sorted;
  3. gather the points into sorted order, lane L of `width` owning the
     sorted chunk [L rows, (L + 1) rows); digit-0 entries and the sentinel
     tail are masked to infinity, negative digits take -P (y negated);
  4. ONE `cmsm_row_scan` launch: every lane's running prefix of complete
     mixed adds down its rows;
  5. lane totals -> exclusive lane prefix (Hillis-Steele, log2(width)
     `cadd` launches), so G[pos] = lane prefix + in-lane prefix is the
     inclusive prefix of the sorted stream at any position (one `cadd`);
  6. each window's weighted bucket sum from prefix differences,
        sum_d d S_{w,d} = sum_{d>=1} [U((w+1) nbuck) - U(w nbuck + d)]
     with U(t) the sum of sorted points with key < t: one `cadd` with
     negated Y, halvings while more than 1024 differences remain, then a
     Hillis-Steele prefix (log2 of the rest) and its last lane;
  7. combine the windows high to low, one `cdbl_n_add` (window doublings,
     then the add) per window.

The reference maps `msm` over a batch with `jax.vmap`; here the leading
batch axes are written out: points (..., N) and scalars (17, ..., N)
broadcast against each other, and every sort, gather and kernel launch runs
once over the whole batch of independent MSMs (their lanes side by side).

Launches per call: `cmsm_row_scan` 1; `cadd` log2(width) + 2 + (halvings
while L > 1024) + log2(L), L = 2^(w-1) after the halvings; `cdbl_n_add`
ceil(256 / w), each with n = w. On the CPU every wrapper runs its plain
version (the dispatch rule of :mod:`.cuda_curve`).

The reference reads its window and width defaults from the environment
(`GsConfig`); the port takes those defaults as constants: window 8 below
16384 points, else 13; width from `_pick_width`.
"""

from __future__ import annotations

import math

import torch

from . import cuda_curve as CC
from . import proj as PJ

NBITS = 256          # scalar width covered by windows (Fr < 2^255)
SIGN_BIT = 31        # the payload's sign bit (point indices < 2^31)


def _digits(scalars_std, window: int):
    """int64[17, *B] standard-form limbs -> int64[n_windows, *B] w-bit
    digits, LSB window first."""
    n_windows = -(-NBITS // window)
    outs = []
    for k in range(n_windows):
        lo_bit = k * window
        limb_i = lo_bit // 16
        off = lo_bit % 16
        d = scalars_std[limb_i] >> off
        have = 16 - off
        if have < window and limb_i + 1 < scalars_std.shape[0]:
            d = d | (scalars_std[limb_i + 1] << have)
        outs.append(d & ((1 << window) - 1))
    return torch.stack(outs)


def _signed_digits(scalars_std, window: int):
    """Signed-digit recoding: (|d| int64[W, *B], neg bool[W, *B]).

    A digit d > 2^(w-1) becomes d - 2^w with a +1 carry into the next
    window, so the bucket domain halves to [0, 2^(w-1)]. The top window
    absorbs the last carry unsigned: Fr < 2^255 leaves >= w - 1 slack bits
    there for the windows used here (asserted).
    """
    n_windows = -(-NBITS // window)
    half = 1 << (window - 1)
    top_bits = 255 - (n_windows - 1) * window
    assert top_bits <= window - 1, \
        f"window {window}: top digit would overflow the signed domain"
    raw = _digits(scalars_std, window)
    outs_abs, outs_neg = [], []
    carry = torch.zeros_like(raw[0])
    for k in range(n_windows):
        d = raw[k] + carry
        if k == n_windows - 1:
            outs_abs.append(d)
            outs_neg.append(torch.zeros(d.shape, dtype=torch.bool,
                                        device=d.device))
        else:
            neg = d > half
            outs_abs.append(torch.where(neg, (1 << window) - d, d))
            outs_neg.append(neg)
            carry = neg.to(torch.int64)
    return torch.stack(outs_abs), torch.stack(outs_neg)


def _pick_width(M: int, width: int | None):
    if width is not None:
        return min(width, M)
    # target ~512 rows; clamp width to [128, 8192], a power of two
    w = max(128, min(8192, M // 512))
    return 1 << (w - 1).bit_length()


def _sorted_stream(scalars_std, window: int):
    """Steps 1-2 over a batch: scalars int64[17, B, N] -> (keys, payload),
    each int64[B, M], M = n_windows N: per window a stable sort of the
    |digit| keys (offset by window * nbuck, so the stream is sorted) with
    payload = point index | sign << SIGN_BIT."""
    n_windows = -(-NBITS // window)
    nbuck = (1 << (window - 1)) + 1
    B, N = scalars_std.shape[1:]
    digs, negs = _signed_digits(scalars_std, window)      # (W, B, N)
    digs, negs = digs.transpose(0, 1), negs.transpose(0, 1)
    idx = torch.arange(N, dtype=torch.int64, device=digs.device)
    payload = idx | (negs.to(torch.int64) << SIGN_BIT)
    digs_s, order = torch.sort(digs, dim=-1, stable=True)
    pay_s = torch.gather(payload, -1, order)
    win = torch.arange(n_windows, dtype=torch.int64,
                       device=digs.device)[:, None] * nbuck
    return (digs_s + win).reshape(B, -1), pay_s.reshape(B, -1)


def _to_lanes(stream, rows: int, width: int):
    """A sorted stream (B, Mp) -> (rows, B, width): element (r, b, L) is
    sorted position L rows + r of MSM b."""
    return stream.reshape(stream.shape[0], width, rows).permute(2, 0, 1)


def _take_batch_rowmajor(curve, pts, idx_s, rows, width):
    """Sorted-order gather of an affine batch (x, y, inf) with batch
    (B, N'): idx_s int64[B, Mp] indices into N'. Returns coordinates laid
    out (25[, 2], rows, B, width) and inf (rows, B, width): the row scan's
    input, one gather per tensor straight into that layout (the reference
    gathers packed rows and transposes)."""
    B, n = pts[2].shape
    flat = _to_lanes(idx_s, rows, width) + n * torch.arange(
        B, dtype=torch.int64, device=idx_s.device)[None, :, None]

    def take(c):
        lead = c.shape[:curve.ns]
        return c.reshape(lead + (B * n,))[..., flat]

    return take(pts[0]), take(pts[1]), pts[2].reshape(B * n)[flat]


def _take_jac(curve, pts, idx):
    """Projective coordinates (..., B, L) at per-MSM lanes idx (B, Q)."""
    return tuple(torch.gather(l, -1, idx.expand(l.shape[:-1] + idx.shape[-1:]))
                 for l in pts)


def _jac_where(mask, a, b):
    return tuple(torch.where(mask, x, y) for x, y in zip(a, b))


def _shift_in(x, pad, shift: int):
    """Along the last axis: `shift` lanes of `pad`, then x without its
    last `shift` lanes."""
    return tuple(torch.cat([p[..., :shift], v[..., :v.shape[-1] - shift]], -1)
                 for p, v in zip(pad, x))


def _prefix(curve, x):
    """Hillis-Steele inclusive prefix along the last axis (a power of two):
    log2(L) `cadd` launches."""
    L = x[0].shape[-1]
    pad = PJ.inf(curve, x[2].shape[curve.ns:], device=x[0].device)
    shift = 1
    while shift < L:
        x = PJ.add(curve, x, _shift_in(x, pad, shift))
        shift *= 2
    return x


def msm(curve, points_aff, scalars_std, window: int = 0,
        width: int | None = None):
    """sum_i scalars[i] * points[i] over the last batch axis, for a batch
    of independent MSMs.

    points_aff: affine (x, y, inf) with batch (*P, N); scalars_std:
    int64[17, *S, N] canonical standard-form limbs; *P and *S broadcast to
    the MSM batch *B. Returns a Jacobian point with batch *B. window 0
    picks the default (8 below 16384 points, else 13); width None picks
    itself (~M/512 lanes, clamped to [128, 8192]).
    """
    ns = curve.ns
    N = points_aff[2].shape[-1]
    window = window or (8 if N < 16384 else 13)
    n_windows = -(-NBITS // window)
    nbuck = (1 << (window - 1)) + 1
    M = N * n_windows
    width = _pick_width(M, width)
    rows = -(-M // width)
    Mp = rows * width
    batch = torch.broadcast_shapes(points_aff[2].shape[:-1],
                                   scalars_std.shape[1:-1])
    B = math.prod(batch)
    dev = points_aff[2].device

    def flat_pts(c, lead):
        """(*lead, *X, N) with *X broadcasting to *B -> (*lead, B, N)."""
        c = c.reshape(c.shape[:lead] + (1,) * (len(batch) + lead + 1 - c.ndim)
                      + c.shape[lead:])
        return c.expand(c.shape[:lead] + batch + (N,)).reshape(
            c.shape[:lead] + (B, N))

    x, y, inf = (flat_pts(points_aff[0], ns), flat_pts(points_aff[1], ns),
                 flat_pts(points_aff[2], 0))
    scal = flat_pts(scalars_std, 1)

    # ---- 1-2: per-window signed-digit sort --------------------------------
    keys_s, pay_s = _sorted_stream(scal, window)           # (B, M)
    if Mp != M:   # sentinel tail keeps the stream sorted
        keys_s = torch.cat([keys_s, keys_s.new_full((B, Mp - M),
                                                    n_windows * nbuck)], 1)
        pay_s = torch.cat([pay_s, pay_s.new_zeros((B, Mp - M))], 1)
    idx_s = pay_s & ((1 << SIGN_BIT) - 1)
    neg_s = pay_s >> SIGN_BIT

    # ---- 3: gather into sorted order; -P for a negative digit --------------
    # The affine y < 2p negates as 2p - y (the reference's F.neg(y, k=2)
    # after its gather): negated once per point here, and the gather picks
    # y or -y by index.
    signed = (torch.cat([x, x], -1),
              torch.cat([y, curve.F.neg(y, k=2)], -1),
              torch.cat([inf, inf], -1))
    px, py, pinf = _take_batch_rowmajor(curve, signed, idx_s + N * neg_s,
                                        rows, width)
    key2 = _to_lanes(keys_s, rows, width)
    pinf = pinf | (key2 % nbuck == 0) | (key2 >= n_windows * nbuck)

    # ---- 4: per-lane running prefix: ONE launch ---------------------------
    lane_tot, ys_raw = CC.cmsm_row_scan((px, py, pinf), curve)
    del px, py, pinf

    # ---- 5: exclusive lane prefix -> global prefix lookup ------------------
    lane_incl = _prefix(curve, lane_tot)
    inf1 = PJ.inf(curve, (B, 1), device=dev)
    lane_excl = _shift_in(lane_incl, inf1, 1)

    def g_at(pos, valid):
        """G[pos], the inclusive prefix at sorted position pos (B, Q), or
        infinity where not valid: the in-lane prefix gathered straight from
        the raw stream, plus the lane's exclusive prefix (one `cadd`)."""
        lane = pos // rows
        row = pos % rows
        flat_lane = lane + width * torch.arange(
            B, dtype=torch.int64, device=dev)[:, None]

        def gather_rc(yr):
            g = yr.reshape(rows, yr.shape[1], B * width)[row, :, flat_lane]
            rc = g.permute(2, 0, 1)                        # (cr, B, Q)
            if ns == 2:
                nl = rc.shape[0] // 2
                return rc.reshape((2, nl) + rc.shape[1:]).transpose(0, 1)
            return rc

        p_local = tuple(gather_rc(yr) for yr in ys_raw)
        g = PJ.add(curve, _take_jac(curve, lane_excl, lane), p_local)
        return _jac_where(valid, g, PJ.inf(curve, pos.shape, device=dev))

    # ---- 6: weighted bucket sums via prefix differences --------------------
    ar = torch.arange(n_windows, dtype=torch.int64, device=dev)
    t_ends = (ar + 1) * nbuck                                       # (W,)
    t_starts = (ar[:, None] * nbuck + torch.arange(
        1, nbuck, dtype=torch.int64, device=dev)[None, :])          # (W, nb-1)
    tgts = torch.cat([t_ends, t_starts.reshape(-1)])
    pos = torch.searchsorted(keys_s, tgts.expand(B, -1).contiguous())
    u_all = g_at((pos - 1).clamp(min=0), pos > 0)
    del ys_raw
    u_end = tuple(l[..., :n_windows] for l in u_all)                # (B, W)
    u_starts = tuple(l[..., n_windows:].reshape(
        l.shape[:-1] + (n_windows, nbuck - 1)) for l in u_all)      # (B, W, nb-1)
    bigL = tuple(l[..., None].expand(l.shape + (nbuck - 1,)) for l in u_end)
    negR = (u_starts[0], curve.F.neg(u_starts[1], k=4), u_starts[2])
    x = PJ.add(curve, bigL, negR)                                   # (B, W, nb-1)

    # window sums: halve the digit axis to <= 1024 lanes, then one
    # Hillis-Steele prefix, and its last lane
    L = nbuck - 1
    while L > 1024:
        half = L // 2
        x = PJ.add(curve, tuple(v[..., :half] for v in x),
                   tuple(v[..., half:] for v in x))
        L = half
    wsums = tuple(v[..., L - 1] for v in _prefix(curve, x))         # (B, W)

    # ---- 7: combine windows: acc = sum_k 2^(w k) wsums[k], high to low -----
    acc = PJ.inf(curve, (B,), device=dev)
    for k in range(n_windows - 1, -1, -1):
        acc = CC.cdbl_n_add(acc, window, tuple(v[..., k] for v in wsums),
                            curve)
    out = PJ.to_jacobian(curve, acc)
    return tuple(c.reshape(c.shape[:ns] + batch) for c in out)


def msm_curve(curve, points_aff, scalars_std, window: int = 8,
              width: int | None = None):
    """Alias with an explicit window, for the parallel layer."""
    return msm(curve, points_aff, scalars_std, window=window, width=width)
