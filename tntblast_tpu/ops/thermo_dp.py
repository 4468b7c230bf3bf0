"""Batched thermodynamic alignment DP on device (JAX/XLA).

Replicates the reference NucCruc dynamic program exactly (reference:
nuc_cruc.cpp:492-696 `align_dimer`): a 3-state (M / I_query / I_target)
local alignment over nearest-neighbor *pair-of-pairs* stacking energies with
fixed-point int32 scores (-dG * 10000), query reversed so rows run 5'query
vs 3'target.  Returns the max M-state score per window — the same value the
reference's `max_score` holds after the DP sweep.

Device mapping: instead of the reference's per-candidate (w+8)^2 scalar loop,
all candidate windows of a fragment are evaluated as one (B, wq, wt) batch.
The column-wise gap state (I_query) recurrence
    Iq[j] = max(A[j], max(Iq[j-1], 0) - E[j])
is an (max,+) prefix recurrence; with A'[j] = max(A[j], -E[j]) it unrolls to
    Iq[j] = cummax(A' + cumsum(E))[j] - cumsum(E)[j]
which turns the whole DP into a lax.scan over wq rows of pure vector ops —
no per-cell control flow, fully vectorized across the batch and target
dimensions.

The per-cell energies are gathered once up-front from the 49x49 delta_g
table (rebuilt per temperature, reference nuc_cruc.cpp:340-487) into seven
(B, wq, wt) matrices, so the scan body is arithmetic only.
"""

import functools

from tntblast_tpu.jaxconf import configure as _jaxconf
_jaxconf()

import jax
import jax.numpy as jnp
import numpy as np

NUM_BASE = 7     # A,C,G,T,I + virtual E,GAP (reference nuc_cruc.h:37-39)
NUM_BP = 49
NUM_ALPHA = 18
GAP = 6

_A, _C, _G, _T, _I = 0, 1, 2, 3, 4
_M, _R, _S, _V, _W = 7, 8, 9, 10, 11
_Y, _H, _K, _D, _B, _N = 12, 13, 14, 15, 16, 17


def _resolve_one(base, q):
    """Optimistic degenerate-base resolution (reference nuc_cruc.cpp:14-201
    `resolve_degenerate`, including the B->N fall-through quirk)."""
    if base == _M:
        return _A if q == _T else (_C if q == _G else _A)
    if base == _R:
        return _A if q == _T else (_G if q == _C else _A)
    if base == _S:
        return _C if q == _G else (_G if q == _C else _G)
    if base == _V:
        return _C if q == _G else (_G if q == _C else (_A if q == _T else _A))
    if base == _W:
        return _T if q == _A else (_A if q == _T else _A)
    if base == _Y:
        return _C if q == _G else (_T if q == _A else _T)
    if base == _H:
        return _A if q == _T else (_C if q == _G else (_T if q == _A else _A))
    if base == _K:
        return _G if q == _C else (_T if q == _A else _T)
    if base == _D:
        return _G if q == _C else (_A if q == _T else (_T if q == _A else _A))
    if base in (_B, _N):
        return {_A: _T, _T: _A, _G: _C, _C: _G}.get(q, _A)
    return base


@functools.lru_cache(maxsize=1)
def best_pair_table():
    """BEST_PAIR[a][b] = resolve(a,b)*7 + resolve(b,a) (reference
    nuc_cruc.cpp:203-213 `best_base_pair`)."""
    bp = np.zeros((NUM_ALPHA, NUM_ALPHA), dtype=np.int32)
    for a in range(NUM_ALPHA):
        for b in range(NUM_ALPHA):
            bp[a, b] = _resolve_one(a, b) * NUM_BASE + _resolve_one(b, a)
    return bp


def _relu(x):
    return jnp.maximum(x, 0)


@functools.partial(jax.jit, static_argnames=("wq", "wt"))
def dp_max_score(q_codes, q_len, t_codes, t_len, delta_g, *, wq, wt):
    """Max M-state DP score for a batch of windows.

    q_codes: (B, wq) int32 melt codes, padded arbitrarily past q_len
    q_len:   (B,) int32 true oligo lengths
    t_codes: (B, wt) int32, padded past t_len
    t_len:   (B,) int32
    delta_g: (49*49,) int32 score table at the screen temperature
    Returns (B,) int32 max scores (== reference NucCruc max_score; -1 when
    no cell scores >= 0... matching the reference's initial max of -1).
    """
    bp = jnp.asarray(best_pair_table())
    dg = delta_g.reshape(-1)

    B = q_codes.shape[0]
    # Row-indexed (reversed query) base array: the reversal starts at the
    # true oligo end (q_len-1), not the padded end, so roll per row
    idx = (q_len[:, None] - 1 - jnp.arange(wq)[None, :]) % wq
    q_rev = jnp.take_along_axis(q_codes, idx, axis=1)

    qb = q_rev                                   # (B, wq) base at row r
    pq = jnp.concatenate(
        [jnp.full((B, 1), GAP, jnp.int32), q_rev[:, :-1]], axis=1)
    tb = t_codes                                 # (B, wt) base at col c
    pt = jnp.concatenate(
        [jnp.full((B, 1), GAP, jnp.int32), t_codes[:, :-1]], axis=1)

    def pair(a, b):
        return bp[a, b]

    cur = pair(tb[:, None, :], qb[:, :, None])           # (B, wq, wt)
    bp_pt_pq = pair(pt[:, None, :], pq[:, :, None])
    bp_pt_gap = pair(pt, jnp.int32(GAP))[:, None, :]     # (B, 1, wt)
    bp_gap_pq = pair(jnp.int32(GAP), pq)[:, :, None]     # (B, wq, 1)
    gq = pair(tb, jnp.int32(GAP))[:, None, :]            # cur pair for Iq
    gt = pair(jnp.int32(GAP), qb)[:, :, None]            # cur pair for It
    bp_pt_qb = pair(pt[:, None, :], qb[:, :, None])
    bp_tb_pq = pair(tb[:, None, :], pq[:, :, None])

    def g(prev_bp, cur_bp):
        return jnp.take(dg, prev_bp * NUM_BP + cur_bp)

    DGmm = g(bp_pt_pq, cur)
    DGmq = g(jnp.broadcast_to(bp_pt_gap, cur.shape), cur)
    DGmt = g(jnp.broadcast_to(bp_gap_pq, cur.shape), cur)
    DGqi = g(bp_pt_qb, jnp.broadcast_to(gq, cur.shape))
    DGqe = g(jnp.broadcast_to(bp_pt_gap, cur.shape),
             jnp.broadcast_to(gq, cur.shape))
    DGti = g(bp_tb_pq, jnp.broadcast_to(gt, cur.shape))
    DGte = g(jnp.broadcast_to(bp_gap_pq, cur.shape),
             jnp.broadcast_to(gt, cur.shape))

    col_valid = jnp.arange(wt)[None, :] < t_len[:, None]     # (B, wt)
    row_valid = jnp.arange(wq)[None, :] < q_len[:, None]     # (B, wq)

    neg1 = jnp.full((B, wt + 1), -1, jnp.int32)

    def row_step(carry, xs):
        prevM, prevIq, prevIt, best = carry
        dgmm, dgmq, dgmt, dgqi, dgqe, dgti, dgte, rvalid = xs

        m = jnp.maximum(
            jnp.maximum(_relu(prevM[:, :-1]) - dgmm,
                        _relu(prevIq[:, :-1]) - dgmq),
            _relu(prevIt[:, :-1]) - dgmt)                     # (B, wt)

        it = jnp.maximum(_relu(prevM[:, 1:]) - dgti,
                         _relu(prevIt[:, 1:]) - dgte)

        m_shift = jnp.concatenate(
            [jnp.full((B, 1), -1, jnp.int32), m[:, :-1]], axis=1)
        a = jnp.maximum(_relu(m_shift) - dgqi, -dgqe)
        s = jnp.cumsum(dgqe, axis=1)
        iq = jax.lax.cummax(a + s, axis=1) - s

        best = jnp.maximum(
            best,
            jnp.max(jnp.where(col_valid & rvalid[:, None], m, -1), axis=1))

        newM = jnp.concatenate([neg1[:, :1], m], axis=1)
        newIq = jnp.concatenate([neg1[:, :1], iq], axis=1)
        newIt = jnp.concatenate([neg1[:, :1], it], axis=1)
        return (newM, newIq, newIt, best), None

    xs = (
        jnp.moveaxis(DGmm, 1, 0), jnp.moveaxis(DGmq, 1, 0),
        jnp.moveaxis(DGmt, 1, 0), jnp.moveaxis(DGqi, 1, 0),
        jnp.moveaxis(DGqe, 1, 0), jnp.moveaxis(DGti, 1, 0),
        jnp.moveaxis(DGte, 1, 0), jnp.moveaxis(row_valid, 1, 0),
    )
    init = (neg1, neg1, neg1, jnp.full((B,), -1, jnp.int32))
    (_, _, _, best), _ = jax.lax.scan(row_step, init, xs)
    return best


def dp_delta_g(q_codes, q_len, t_codes, t_len, delta_g, *, wq, wt):
    """DP best free energy in kcal/mol (== -max_score/10000; the reference
    dp ΔG used by tm_dimer before exact re-scoring)."""
    score = dp_max_score(q_codes, q_len, t_codes, t_len, delta_g,
                         wq=wq, wt=wt)
    return -score.astype(jnp.float32) / jnp.float32(10000.0)


NUM_T5 = 5            # target-domain letters on the device path: A,C,G,T,I
NUM_PREV = 6          # prev-target letters: A,C,G,T,I + GAP (column 0)

# ---------------------------------------------------------------------------
# Canonical-pair DP: the exact-integer device formulation.
#
# The per-(slot, row) energy tables only depend on the slot's (prev_q,
# cur_q) base pair at that row — and on the device path both query and target
# codes are confined to {A,C,G,T,I} (+GAP at the boundary).  So the whole
# energy model collapses to ONE canonical table
#
#     T_canon[(pt6*5+tb), (pq6*5+qb), e]   (30, 30, 7) int32
#
# built from the 49x49 delta_g at a screening temperature, gathered per DP
# row with integer indices: zero matmuls, bit-exact int32 scores (the same
# values align_dimer computes), no margin.  Per-slot state shrinks to a
# (num_os, wq) int8 "qpair row" array.

QP_GAP = 5   # 6th letter of the prev-base domain (GAP at row/col 0)


def build_qpair_rows(slot_codes, slot_qlen, *, wq):
    """(S, wq) int32: qpair index pq6*5+qb per DP row (reversed query).
    Rows past slot_qlen hold 0 (masked by row_valid in the DP)."""
    S = len(slot_codes)
    out = np.zeros((S, wq), dtype=np.int32)
    for s in range(S):
        n = int(slot_qlen[s])
        rev = np.asarray(slot_codes[s][:n][::-1], dtype=np.int64)
        for r in range(n):
            qb = int(rev[r])
            pq6 = int(rev[r - 1]) if r > 0 else QP_GAP
            out[s, r] = pq6 * NUM_T5 + qb
    return out


@functools.lru_cache(maxsize=None)
def _t_canon_cached(dg_key):
    dg = np.frombuffer(dg_key, dtype=np.int32)
    return _build_t_canon(dg)


def _build_t_canon(dg):
    """(30, 30, 7) int32 canonical energy table from a flat (2401,) dg."""
    dg = np.asarray(dg).reshape(-1)
    base6 = np.array([0, 1, 2, 3, 4, GAP])      # domain letter -> melt code

    def bp(a, b):
        return a * NUM_BASE + b

    T = np.zeros((NUM_PREV * NUM_T5, NUM_PREV * NUM_T5, 7), dtype=np.int32)
    for pt6 in range(NUM_PREV):
        pt = base6[pt6]
        for tb in range(NUM_T5):
            i = pt6 * NUM_T5 + tb
            for pq6 in range(NUM_PREV):
                pq = base6[pq6]
                for qb in range(NUM_T5):
                    j = pq6 * NUM_T5 + qb
                    cur = bp(tb, qb)
                    T[i, j, 0] = dg[bp(pt, pq) * NUM_BP + cur]
                    T[i, j, 1] = dg[bp(pt, GAP) * NUM_BP + cur]
                    T[i, j, 2] = dg[bp(GAP, pq) * NUM_BP + cur]
                    T[i, j, 3] = dg[bp(pt, qb) * NUM_BP + bp(tb, GAP)]
                    T[i, j, 4] = dg[bp(pt, GAP) * NUM_BP + bp(tb, GAP)]
                    T[i, j, 5] = dg[bp(tb, pq) * NUM_BP + bp(GAP, qb)]
                    T[i, j, 6] = dg[bp(GAP, pq) * NUM_BP + bp(GAP, qb)]
    return T


def build_t_canon(dg):
    return _t_canon_cached(np.ascontiguousarray(
        np.asarray(dg, dtype=np.int32)).tobytes())


def dp_scores_canon(qp_rows, q_len, t_codes, t_len, t_canon, *, wq, wt):
    """Exact int32 max M-state DP score per window (== dp_max_score ==
    the reference align_dimer max_score) via the canonical-pair table.

    qp_rows: (B, wq) int32 qpair per row (build_qpair_rows[os_idx])
    q_len:   (B,) int32
    t_codes: (B, wt) int32 melt codes in {0..4} (others must go host-side)
    t_len:   (B,) int32
    t_canon: (30, 30, 7) int32
    """
    B = t_codes.shape[0]
    tb5 = jnp.clip(t_codes, 0, NUM_T5 - 1)
    pt6 = jnp.concatenate(
        [jnp.full((B, 1), QP_GAP, jnp.int32), tb5[:, :-1]], axis=1)
    ptb = pt6 * NUM_T5 + tb5                        # (B, wt) in [0, 30)

    Tflat = t_canon.reshape(NUM_PREV * NUM_T5 * NUM_PREV * NUM_T5, 7)
    col_valid = jnp.arange(wt)[None, :] < t_len[:, None]
    row_valid = jnp.arange(wq)[None, :] < q_len[:, None]
    neg1 = jnp.full((B, wt + 1), -1, jnp.int32)

    def row_step(carry, xs):
        prevM, prevIq, prevIt, best = carry
        qp_r, rvalid = xs                            # (B,), (B,)
        e = jnp.take(Tflat, ptb * (NUM_PREV * NUM_T5) + qp_r[:, None],
                     axis=0)                         # (B, wt, 7)
        dgmm, dgmq, dgmt = e[..., 0], e[..., 1], e[..., 2]
        dgqi, dgqe = e[..., 3], e[..., 4]
        dgti, dgte = e[..., 5], e[..., 6]

        m = jnp.maximum(
            jnp.maximum(_relu(prevM[:, :-1]) - dgmm,
                        _relu(prevIq[:, :-1]) - dgmq),
            _relu(prevIt[:, :-1]) - dgmt)
        it = jnp.maximum(_relu(prevM[:, 1:]) - dgti,
                         _relu(prevIt[:, 1:]) - dgte)
        m_shift = jnp.concatenate(
            [jnp.full((B, 1), -1, jnp.int32), m[:, :-1]], axis=1)
        a = jnp.maximum(_relu(m_shift) - dgqi, -dgqe)
        s = jnp.cumsum(dgqe, axis=1)
        iq = jax.lax.cummax(a + s, axis=1) - s

        best = jnp.maximum(
            best,
            jnp.max(jnp.where(col_valid & rvalid[:, None], m, -1), axis=1))
        newM = jnp.concatenate([neg1[:, :1], m], axis=1)
        newIq = jnp.concatenate([neg1[:, :1], iq], axis=1)
        newIt = jnp.concatenate([neg1[:, :1], it], axis=1)
        return (newM, newIq, newIt, best), None

    xs = (jnp.moveaxis(qp_rows, 1, 0), jnp.moveaxis(row_valid, 1, 0))
    init = (neg1, neg1, neg1, jnp.full((B,), -1, jnp.int32))
    (_, _, _, best), _ = jax.lax.scan(row_step, init, xs)
    return best
