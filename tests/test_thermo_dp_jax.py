"""Parity of the device DP kernel against the native engine's DP score.

The JAX batched DP must reproduce the reference align_dimer max score
exactly (int32 fixed point) — it is the screening stage of the device
pipeline and its conservativeness proof assumes score equality.
"""

import numpy as np
import pytest

from tntblast_tpu import native
from tntblast_tpu.ops import thermo_dp

BASES = "ACGT"
DEGEN = "ACGTIMRSVWYHKDBN"


@pytest.fixture(scope="module")
def engine():
    return native.MeltEngine(n_threads=1)


def _rand_seqs(rng, n, lmin, lmax, alphabet):
    return ["".join(rng.choice(list(alphabet), rng.integers(lmin, lmax + 1)))
            for _ in range(n)]


def _native_dp(engine, qs, ts):
    out = engine.eval_batch(
        native.HETERO,
        [native.seq_to_codes(q) for q in qs],
        [native.seq_to_codes(t) for t in ts],
        np.full(len(qs), 9e-7, dtype=np.float32))
    return out["dp_dg"]


def _jax_dp(engine, qs, ts, wq, wt):
    """Raw JAX DP score converted to the native dp_dg convention: the
    native engine adds the duplex initiation dG when reporting
    (melt_engine.cpp:1412, mirroring reference evaluate_alignment)."""
    import jax.numpy as jnp
    B = len(qs)
    qc = np.zeros((B, wq), dtype=np.int32)
    tc = np.zeros((B, wt), dtype=np.int32)
    ql = np.zeros(B, dtype=np.int32)
    tl = np.zeros(B, dtype=np.int32)
    for i, (q, t) in enumerate(zip(qs, ts)):
        cq = native.seq_to_codes(q)
        ct = native.seq_to_codes(t)
        qc[i, :len(cq)] = cq
        tc[i, :len(ct)] = ct
        ql[i] = len(cq)
        tl[i] = len(ct)
    dg_table = engine.delta_g().astype(np.int32).reshape(-1)
    score = thermo_dp.dp_max_score(
        jnp.asarray(qc), jnp.asarray(ql), jnp.asarray(tc), jnp.asarray(tl),
        jnp.asarray(dg_table), wq=wq, wt=wt)
    t = engine._tables
    dp = -np.asarray(score).astype(np.float32) / np.float32(10000.0)
    # same float association order as the native engine
    # (melt_engine.cpp:1412): (dp + init_H) - base_T*init_S
    return ((dp + np.float32(t.param_init_H))
            - np.float32(engine.target_T) * np.float32(t.param_init_S))


def test_dp_matches_native_random_atgc(engine):
    rng = np.random.default_rng(7)
    qs = _rand_seqs(rng, 64, 8, 30, BASES)
    ts = _rand_seqs(rng, 64, 8, 38, BASES)
    want = _native_dp(engine, qs, ts)
    got = _jax_dp(engine, qs, ts, wq=30, wt=38)
    np.testing.assert_array_equal(got, want)


def test_dp_matches_native_complementary(engine):
    """Perfect and near-perfect duplexes (the high-score regime)."""
    rng = np.random.default_rng(8)
    comp = str.maketrans("ACGT", "TGCA")
    qs, ts = [], []
    for _ in range(48):
        q = "".join(rng.choice(list(BASES), rng.integers(15, 28)))
        t = q.translate(comp)[::-1]
        # flanks + occasional mutation
        t = ("".join(rng.choice(list(BASES), 4)) + t
             + "".join(rng.choice(list(BASES), 4)))
        if rng.random() < 0.5:
            p = rng.integers(0, len(t))
            t = t[:p] + rng.choice(list(BASES)) + t[p + 1:]
        qs.append(q)
        ts.append(t)
    want = _native_dp(engine, qs, ts)
    got = _jax_dp(engine, qs, ts, wq=28, wt=36)
    np.testing.assert_array_equal(got, want)


def test_dp_matches_native_degenerate_targets(engine):
    rng = np.random.default_rng(9)
    qs = _rand_seqs(rng, 48, 8, 24, BASES + "I")
    ts = _rand_seqs(rng, 48, 8, 32, DEGEN)
    want = _native_dp(engine, qs, ts)
    got = _jax_dp(engine, qs, ts, wq=24, wt=32)
    np.testing.assert_array_equal(got, want)


def test_dp_other_temperature(engine):
    """Screen runs the DP at Tk = min_tm + 273.15, not target_t."""
    rng = np.random.default_rng(10)
    qs = _rand_seqs(rng, 32, 10, 24, BASES)
    ts = _rand_seqs(rng, 32, 10, 30, BASES)
    eng2 = native.MeltEngine(target_T=313.15, n_threads=1)
    want = _native_dp(eng2, qs, ts)
    import jax.numpy as jnp
    got = _jax_dp(eng2, qs, ts, wq=24, wt=30)
    np.testing.assert_array_equal(got, want)
