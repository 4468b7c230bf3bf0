"""eval_segment (jit) vs the native engine: every window the device
marks trusted must carry bit-exact evaluation results, and the trusted
rate must stay high."""

import numpy as np
import pytest

from tntblast_tpu import native
from tntblast_tpu.ops import eval_gapless as eg
from tntblast_tpu.ops.eval_gapless_jax import (
    build_slot_eval_arrays, eval_segment)
from tntblast_tpu.thermo.santa_lucia import build_tables

NUM_BASE = 7
NUM_BP = 49
GAP = 6


@pytest.fixture(scope="module")
def engine():
    return native.MeltEngine(n_threads=1)


@pytest.fixture(scope="module")
def tables():
    return build_tables()


def _dp_rows(q, t_batch, dg):
    """numpy DP producing eval_segment's inputs: full-DP M rows plus the
    gapped-best channel max (no-restart Mg)."""
    ql = len(q)
    B, wt = t_batch.shape
    M = np.full((B, ql + 1, wt + 1), -1, dtype=np.int64)
    Iq = np.full((B, ql + 1, wt + 1), -1, dtype=np.int64)
    It = np.full((B, ql + 1, wt + 1), -1, dtype=np.int64)
    NEG = -(1 << 29)
    Mg = np.full((B, ql + 1, wt + 1), NEG, dtype=np.int64)

    def bp(a, b):
        return a * NUM_BASE + b

    relu = lambda x: np.maximum(x, 0)   # noqa: E731
    for i in range(1, ql + 1):
        qb = int(q[ql - i])
        pq = GAP if i == 1 else int(q[ql - (i - 1)])
        for j in range(1, wt + 1):
            tb = t_batch[:, j - 1]
            pt = np.full(B, GAP, dtype=np.int64) if j == 1 \
                else t_batch[:, j - 2]
            cur = bp(tb, qb)
            emm = dg[bp(pt, pq) * NUM_BP + cur]
            emq = dg[bp(pt, GAP) * NUM_BP + cur]
            emt = dg[bp(GAP, pq) * NUM_BP + cur]
            d1 = relu(M[:, i-1, j-1]) - emm
            d2 = relu(Iq[:, i-1, j-1]) - emq
            d3 = relu(It[:, i-1, j-1]) - emt
            M[:, i, j] = np.maximum(np.maximum(d1, d2), d3)
            g1 = np.where(Mg[:, i-1, j-1] >= 0,
                          Mg[:, i-1, j-1] - emm, NEG)
            Mg[:, i, j] = np.maximum(np.maximum(g1, d2), d3)
            cg = bp(tb, GAP)
            Iq[:, i, j] = np.maximum(
                relu(M[:, i, j-1]) - dg[bp(pt, qb) * NUM_BP + cg],
                relu(Iq[:, i, j-1]) - dg[bp(pt, GAP) * NUM_BP + cg])
            cg2 = bp(GAP, qb)
            It[:, i, j] = np.maximum(
                relu(M[:, i-1, j]) - dg[bp(tb, pq) * NUM_BP + cg2],
                relu(It[:, i-1, j]) - dg[bp(GAP, pq) * NUM_BP + cg2])
    M_rows = np.moveaxis(M[:, 1:, :], 0, 1).astype(np.int32)  # (ql,B,wt+1)
    mg_max = Mg[:, 1:, 1:].max(axis=(1, 2)).astype(np.int32)
    return M_rows, mg_max


def test_eval_segment_bit_exact(engine, tables):
    rng = np.random.default_rng(7)
    ql = 19
    q = rng.integers(0, 4, ql).astype(np.uint8)
    q[5] = 4    # an inosine
    wt = ql + 8
    B = 96
    t_batch = rng.integers(0, 4, (B, wt)).astype(np.int64)
    site = (3 - q[::-1].astype(np.int64)) % 4
    site[q[::-1] == 4] = rng.integers(0, 4)
    for b in range(0, B, 2):
        off = int(rng.integers(0, wt - ql + 1))
        t_batch[b, off:off + ql] = site
        for _ in range(int(rng.integers(0, 5))):
            t_batch[b, int(rng.integers(0, wt))] = rng.integers(0, 4)

    dg = engine.delta_g().astype(np.int64).reshape(-1)
    M_rows, mg_max = _dp_rows(q, t_batch, dg)

    tabs = build_slot_eval_arrays(q, tables)
    out = eval_segment(np.asarray(M_rows), np.asarray(mg_max),
                       t_batch.astype(np.int32), tabs)
    out = {k: np.asarray(v) for k, v in out.items()}

    conc = np.float32(9e-7)
    ref = engine.eval_batch(
        native.HETERO, [q] * B, [t_batch[b].astype(np.uint8)
                                 for b in range(B)],
        np.full(B, conc, dtype=np.float32))

    n_trusted = 0
    for b in range(B):
        # cross-check the trust decision against the scalar reference walk
        status = eg.trusted_path_np(q, t_batch[b], dg)[0]
        if not out["trusted"][b]:
            continue
        assert status in ("trusted", "no_align"), (b, status)
        n_trusted += 1
        if out["tm_zero"][b]:
            assert ref["tm"][b] == np.float32(0.0), b
            continue
        tm, dS_final = eg.finish_eval(out["dH"][b], out["dS"][b],
                                      int(out["num_base"][b]),
                                      engine.na, conc)
        assert tm == ref["tm"][b], (b, tm, ref["tm"][b])
        assert out["dH"][b] == ref["dH"][b], b
        assert dS_final == ref["dS"][b], b
        assert [out["fm_q"][b], out["lm_q"][b]] == list(ref["q_range"][b]), b
        q_aligned = out["lm_q"][b] - out["fm_q"][b] + 1
        assert out["mm"][b] + (ql - q_aligned) == ref["num_mm"][b], b
        assert out["anchor5"][b] == ref["anchor5"][b], b
        assert out["anchor3"][b] == ref["anchor3"][b], b

    assert n_trusted > 0.6 * B, n_trusted


@pytest.mark.parametrize("seed_val,ql", [(11, 15), (12, 18), (13, 22),
                                         (14, 25), (15, 30)])
def test_eval_segment_stress(engine, tables, seed_val, ql):
    """Bit-exactness at scale: many window populations per oligo length —
    perfect sites, 1-6 scattered mutations, clustered mismatches, random
    junk — every trusted window must match the engine exactly."""
    rng = np.random.default_rng(seed_val)
    q = rng.integers(0, 4, ql).astype(np.uint8)
    if seed_val % 2:
        q[ql // 2] = 4      # inosine
    wt = ql + 8
    B = 192
    t_batch = rng.integers(0, 4, (B, wt)).astype(np.int64)
    site = (3 - q.astype(np.int64)) % 4
    site[q == 4] = 0
    for b in range(B):
        mode = b % 4
        if mode == 0:
            off = int(rng.integers(0, wt - ql + 1))
            t_batch[b, off:off + ql] = site[::-1]
            for _ in range(int(rng.integers(0, 7))):
                t_batch[b, int(rng.integers(0, wt))] = rng.integers(0, 4)
        elif mode == 1:
            off = 4
            t_batch[b, off:off + ql] = site[::-1]
            s0 = int(rng.integers(1, ql - 5))
            m = int(rng.integers(2, 6))
            for k in range(s0, min(s0 + m, ql - 1)):
                cur = t_batch[b, off + k]
                t_batch[b, off + k] = (cur + 1 + rng.integers(0, 3)) % 4

    dg = engine.delta_g().astype(np.int64).reshape(-1)
    M_rows, mg_max = _dp_rows(q, t_batch, dg)
    tabs = build_slot_eval_arrays(q, tables)
    out = eval_segment(np.asarray(M_rows), np.asarray(mg_max),
                       t_batch.astype(np.int32), tabs)
    out = {k: np.asarray(v) for k, v in out.items()}

    conc = np.float32(9e-7)
    ref = engine.eval_batch(
        native.HETERO, [q] * B,
        [t_batch[b].astype(np.uint8) for b in range(B)],
        np.full(B, conc, dtype=np.float32))

    n_trusted = 0
    for b in range(B):
        if not out["trusted"][b]:
            continue
        n_trusted += 1
        if out["tm_zero"][b]:
            assert ref["tm"][b] == np.float32(0.0), b
            continue
        tm, dS_final = eg.finish_eval(out["dH"][b], out["dS"][b],
                                      int(out["num_base"][b]),
                                      engine.na, conc)
        assert tm == ref["tm"][b], (b, tm, ref["tm"][b])
        assert out["dH"][b] == ref["dH"][b], b
        assert dS_final == ref["dS"][b], b
        assert out["anchor5"][b] == ref["anchor5"][b], b
        assert out["anchor3"][b] == ref["anchor3"][b], b
        q_aligned = out["lm_q"][b] - out["fm_q"][b] + 1
        assert out["mm"][b] + (ql - q_aligned) == ref["num_mm"][b], b
    assert n_trusted > 0.5 * B, n_trusted


def test_eval_flat_matches_segment(engine, tables):
    """eval_flat (flat mixed-slot pool, per-entry ql/wt as data, padded
    rows/cols filled with JUNK) must reproduce eval_segment field-for-
    field on every entry — the padding masks may not leak."""
    from tntblast_tpu.ops.eval_gapless_jax import eval_flat

    rng = np.random.default_rng(23)
    slots = []
    for ql in (15, 19, 24):
        q = rng.integers(0, 4, ql).astype(np.uint8)
        if ql == 19:
            q[5] = 4            # an inosine slot
        slots.append(q)
    wq_max = max(len(q) for q in slots)
    wt_max = wq_max + 8
    dg = engine.delta_g().astype(np.int64).reshape(-1)

    seg_outs = []
    flat_M = []
    flat_mg = []
    flat_t = []
    flat_q = []
    flat_ql = []
    flat_wt = []
    flat_sl = []
    ev_tabs = np.zeros((len(slots), wq_max, 25, 4), np.float32)
    ev_loop = np.zeros((len(slots), wq_max + 2), np.float32)
    eval_const = None
    for s, q in enumerate(slots):
        ql = len(q)
        wt = ql + 8
        B = 40
        t_batch = rng.integers(0, 4, (B, wt)).astype(np.int64)
        site = (3 - q[::-1].astype(np.int64)) % 4
        site[q[::-1] == 4] = rng.integers(0, 4)
        for b in range(0, B, 2):
            off = int(rng.integers(0, wt - ql + 1))
            t_batch[b, off:off + ql] = site
            for _ in range(int(rng.integers(0, 4))):
                t_batch[b, int(rng.integers(0, wt))] = rng.integers(0, 4)
        M_rows, mg_max = _dp_rows(q, t_batch, dg)
        tabs = build_slot_eval_arrays(q, tables)
        seg_outs.append({k: np.asarray(v) for k, v in eval_segment(
            np.asarray(M_rows), np.asarray(mg_max),
            t_batch.astype(np.int32), tabs).items()})
        ev_tabs[s, :ql, :, 0] = tabs["Hstk"]
        ev_tabs[s, :ql, :, 1] = tabs["Sstk"]
        ev_tabs[s, :ql, :, 2] = tabs["Hlt"]
        ev_tabs[s, :ql, :, 3] = tabs["Slt"]
        ev_loop[s, :ql + 1] = tabs["loop2m"]
        eval_const = (float(tabs["AT_H"]), float(tabs["AT_S"]),
                      float(tabs["init_H"]), float(tabs["init_S"]))
        # pad rows/cols with JUNK: masking must make it invisible
        Mp = rng.integers(-5, 99999, (wq_max, B, wt_max + 1)).astype(
            np.int32)
        Mp[:ql, :, :wt + 1] = M_rows
        # junk must not sit inside the real extent's boundary column
        flat_M.append(Mp)
        flat_mg.append(mg_max)
        tp = rng.integers(0, 5, (B, wt_max)).astype(np.int32)
        tp[:, :wt] = t_batch
        flat_t.append(tp)
        qp = np.zeros((B, wq_max), np.int32)
        qp[:, :ql] = q
        flat_q.append(qp)
        flat_ql.append(np.full(B, ql, np.int32))
        flat_wt.append(np.full(B, wt, np.int32))
        flat_sl.append(np.full(B, s, np.int32))

    M_all = np.concatenate(flat_M, axis=1)
    out = eval_flat(
        M_all, np.concatenate(flat_mg),
        np.concatenate(flat_t), np.concatenate(flat_q),
        np.concatenate(flat_ql), np.concatenate(flat_wt),
        (np.concatenate(flat_sl)[:, None]
         == np.arange(len(slots))[None, :]).astype(np.float32),
        ev_tabs, ev_loop, eval_const)
    out = {k: np.asarray(v) for k, v in out.items()}

    off = 0
    for s, seg in enumerate(seg_outs):
        B = len(seg["trusted"])
        for k in seg:
            got = out[k][off:off + B]
            if seg[k].dtype == np.float32:
                np.testing.assert_array_equal(
                    got.view(np.int32), seg[k].view(np.int32),
                    err_msg=f"slot {s} field {k}")
            else:
                np.testing.assert_array_equal(got, seg[k],
                                              err_msg=f"slot {s} field {k}")
        off += B


@pytest.mark.gpu
def test_eval_flat_matches_native_on_gpu(gpu, engine, tables):
    """eval_flat on the card at bench widths (the bench panel's 20-24 nt
    primers padded to 24 rows, 32-column windows), against the native
    engine: every trusted window's dH and dS as float32 bit patterns,
    Tm, ranges, mismatches and anchors must match exactly."""
    import os

    import bench_data
    from tntblast_tpu.ops.eval_gapless_jax import eval_flat

    work = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bench_work")
    _, panel_path = bench_data.build(work)
    from tntblast_tpu import constants as C
    slots = [C.ASCII_TO_MELT[np.frombuffer(oligo.encode(), np.uint8)]
             for line in open(panel_path).read().split("\n")
             for oligo in line.split("\t")[1:]]
    wq_max, wt_max = 24, 32
    rng = np.random.default_rng(bench_data.SEED)
    dg = engine.delta_g().astype(np.int64).reshape(-1)
    ev_tabs = np.zeros((len(slots), wq_max, 25, 4), np.float32)
    ev_loop = np.zeros((len(slots), wq_max + 2), np.float32)
    cols = {k: [] for k in ("M", "mg", "t", "q", "ql", "wt", "sl")}
    per_slot = []
    B = 128
    for s, q in enumerate(slots):
        ql = len(q)
        wt = ql + 8
        t_batch = rng.integers(0, 4, (B, wt)).astype(np.int64)
        site = (3 - q[::-1].astype(np.int64)) % 4
        for b in range(0, B, 2):
            off = int(rng.integers(0, wt - ql + 1))
            t_batch[b, off:off + ql] = site
            for _ in range(int(rng.integers(0, 5))):
                t_batch[b, int(rng.integers(0, wt))] = rng.integers(0, 4)
        M_rows, mg_max = _dp_rows(q, t_batch, dg)
        tabs = build_slot_eval_arrays(q, tables)
        ev_tabs[s, :ql, :, 0] = tabs["Hstk"]
        ev_tabs[s, :ql, :, 1] = tabs["Sstk"]
        ev_tabs[s, :ql, :, 2] = tabs["Hlt"]
        ev_tabs[s, :ql, :, 3] = tabs["Slt"]
        ev_loop[s, :ql + 1] = tabs["loop2m"]
        eval_const = (float(tabs["AT_H"]), float(tabs["AT_S"]),
                      float(tabs["init_H"]), float(tabs["init_S"]))
        Mp = np.full((wq_max, B, wt_max + 1), -1, np.int32)
        Mp[:ql, :, :wt + 1] = M_rows
        cols["M"].append(Mp)
        cols["mg"].append(mg_max)
        tp = np.zeros((B, wt_max), np.int32)
        tp[:, :wt] = t_batch
        cols["t"].append(tp)
        qp = np.zeros((B, wq_max), np.int32)
        qp[:, :ql] = q
        cols["q"].append(qp)
        cols["ql"].append(np.full(B, ql, np.int32))
        cols["wt"].append(np.full(B, wt, np.int32))
        cols["sl"].append(np.full(B, s, np.int32))
        per_slot.append((q, t_batch))

    sl = np.concatenate(cols["sl"])
    out = eval_flat(
        np.concatenate(cols["M"], axis=1), np.concatenate(cols["mg"]),
        np.concatenate(cols["t"]), np.concatenate(cols["q"]),
        np.concatenate(cols["ql"]), np.concatenate(cols["wt"]),
        (sl[:, None] == np.arange(len(slots))[None, :]).astype(np.float32),
        ev_tabs, ev_loop, eval_const)
    out = {k: np.asarray(v) for k, v in out.items()}

    conc = np.float32(9e-7)
    n_trusted = 0
    for s, (q, t_batch) in enumerate(per_slot):
        ref = engine.eval_batch(
            native.HETERO, [q] * B,
            [t_batch[b].astype(np.uint8) for b in range(B)],
            np.full(B, conc, dtype=np.float32))
        for b in range(B):
            i = s * B + b
            if not out["trusted"][i]:
                continue
            n_trusted += 1
            if out["tm_zero"][i]:
                assert ref["tm"][b] == np.float32(0.0), (s, b)
                continue
            tm, dS_final = eg.finish_eval(out["dH"][i], out["dS"][i],
                                          int(out["num_base"][i]),
                                          engine.na, conc)
            assert tm == ref["tm"][b], (s, b)
            assert (np.float32(out["dH"][i]).view(np.int32)
                    == np.float32(ref["dH"][b]).view(np.int32)), (s, b)
            assert (np.float32(dS_final).view(np.int32)
                    == np.float32(ref["dS"][b]).view(np.int32)), (s, b)
            assert ([out["fm_q"][i], out["lm_q"][i]]
                    == list(ref["q_range"][b])), (s, b)
            q_aligned = out["lm_q"][i] - out["fm_q"][i] + 1
            assert out["mm"][i] + (len(q) - q_aligned) == ref["num_mm"][b]
            assert out["anchor5"][i] == ref["anchor5"][b], (s, b)
            assert out["anchor3"][i] == ref["anchor3"][b], (s, b)
    assert n_trusted > 0.5 * len(sl), n_trusted
