"""Device full-fragment pipeline vs the host reference implementations:
seed-diagonal sets must match exactly (including representative (k, t)
pairs), and the screening verdicts must be conservative (never drop a
window the exact engine would pass)."""

import numpy as np
import pytest

from tntblast_tpu import constants as C
from tntblast_tpu import native
from tntblast_tpu.parallel.device_search import (
    INT_MIN, DevicePanel, PanelConfig)
from tntblast_tpu.search import seed


def _mk_panel(oligos, word_len):
    panel = []
    for oligo, minus in oligos:
        codes = C.ASCII_TO_MELT[np.frombuffer(oligo.encode(), np.uint8)]
        words = seed.oligo_word_list(codes, word_len, complement=not minus)
        panel.append({"words": words, "codes": codes, "minus": minus})
    return panel


@pytest.fixture(scope="module")
def engine():
    return native.MeltEngine(n_threads=1)


def test_device_seeds_match_host(engine):
    rng = np.random.default_rng(3)
    frag = rng.integers(0, 4, 30000).astype(np.uint8)
    # sprinkle degenerate and unknown bases
    for pos in rng.integers(0, 30000, 50):
        frag[pos] = rng.integers(4, 18)

    fwd = "TTGACCTAGATATTCAGCAAC"
    rev = "GGGAGAGACTCACCCAAAGATC"
    oligos = [(fwd, True), (fwd, False), (rev, True), (rev, False)]
    w = 7

    cfg = PanelConfig(word_len=w, num_os=4, max_words=16, wq_max=22,
                      tile_len=32768, cap=512, num_cond=1)
    dg = engine.delta_g().astype(np.int32).reshape(1, -1)
    thr = np.full((1, 4), INT_MIN, dtype=np.int32)
    panel = DevicePanel(_mk_panel(oligos, w), cfg, dg, thr)
    out = panel.run_fragment(frag)
    assert not out["overflow"]

    host_frag = seed.FragmentIndex(frag, w)
    for i, (oligo, minus) in enumerate(oligos):
        codes = C.ASCII_TO_MELT[np.frombuffer(oligo.encode(), np.uint8)]
        q, t = seed.find_seeds(host_frag, codes, complement=not minus)
        q, t = seed.unique_diagonal_seeds(q, t)
        sel = out["os_idx"] == i
        dev_p = out["p"][sel]
        dev_k = out["kmin"][sel]
        # host order: ascending delta == descending p
        host_p = (t - q)[::-1]
        host_k = q[::-1]
        np.testing.assert_array_equal(np.sort(dev_p), np.sort(host_p))
        # representative = first occurrence = smallest word index
        host_by_p = dict(zip(host_p, host_k))
        for p, k in zip(dev_p, dev_k):
            assert host_by_p[p] == k, (i, p, k, host_by_p[p])


def test_mesh_panel_matches_single_device(engine):
    """Sharding fragments over an 8-device mesh must reproduce the
    single-device fragment step exactly (same candidates, same verdicts),
    including inert padding fragments."""
    import jax
    from tntblast_tpu.parallel.mesh import MeshPanel, make_mesh

    rng = np.random.default_rng(7)
    frags = [rng.integers(0, 4, rng.integers(2000, 12000)).astype(np.uint8)
             for _ in range(11)]  # 11 -> padded to 16 on 8 devices

    fwd = "TTGACCTAGATATTCAGCAAC"
    rev = "GGGAGAGACTCACCCAAAGATC"
    oligos = [(fwd, True), (fwd, False), (rev, True), (rev, False)]
    w = 7

    cfg = PanelConfig(word_len=w, num_os=4, max_words=16, wq_max=22,
                      tile_len=16384, cap=512, num_cond=1)
    dg = engine.delta_g().astype(np.int32).reshape(1, -1)
    thr = np.full((1, 4), INT_MIN, dtype=np.int32)

    mesh = make_mesh(jax.devices())
    assert mesh.devices.size == 8
    mp = MeshPanel(_mk_panel(oligos, w), cfg, dg, thr, mesh=mesh)
    sp = DevicePanel(_mk_panel(oligos, w), cfg, dg, thr)

    mesh_out = mp.run_fragments(frags)
    for frag, mo in zip(frags, mesh_out):
        so = sp.run_fragment(frag)
        for key in ("os_idx", "p", "kmin", "keep", "needs_host", "counts"):
            np.testing.assert_array_equal(mo[key], so[key], err_msg=key)
        assert mo["overflow"] == so["overflow"]


def test_device_screen_conservative(engine):
    """Every window the exact engine reports above threshold must be kept
    by the device verdict."""
    rng = np.random.default_rng(4)
    fwd = "TTGACCTAGATATTCAGCAAC"
    frag_s = "".join(rng.choice(list("ACGT"), 60000))
    # plant exact, 1-mm and 2-mm sites; "bind to minus strand" means the
    # plus strand carries the oligo sequence itself
    site = fwd
    for pos, nmut in ((5000, 0), (15000, 1), (25000, 2), (35000, 3)):
        s = list(site)
        for _ in range(nmut):
            q = rng.integers(0, len(s))
            s[q] = rng.choice(list("ACGT"))
        frag_s = frag_s[:pos] + "".join(s) + frag_s[pos + len(s):]
    frag = C.ASCII_TO_DB[np.frombuffer(frag_s.encode(), np.uint8)]

    w = 7
    min_tm = 40.0
    conc = 9e-7
    from tntblast_tpu.screen import DeviceScreen
    scr = DeviceScreen(engine, dangle=False)
    conds = scr.conditions({"min_tm": min_tm, "max_dg": 0.0}, conc)
    dg = np.stack([np.asarray(scr._dg_table(T)) for _, T, _ in conds])
    thr = np.array([[ms] for _, _, ms in conds], dtype=np.int32)

    cfg = PanelConfig(word_len=w, num_os=1, max_words=16, wq_max=21,
                      tile_len=65536, cap=1024, num_cond=len(conds))
    panel = DevicePanel(_mk_panel([(fwd, True)], w), cfg, dg, thr)
    out = panel.run_fragment(frag)
    assert not out["overflow"]

    # exact evaluation of every candidate window
    codes = C.ASCII_TO_MELT[np.frombuffer(fwd.encode(), np.uint8)]
    comp_lut = C.DB_TO_MELT_COMPLEMENT
    queries, targets = [], []
    for p in out["p"]:
        start = max(int(p) - 4, 0)
        stop = min(start + len(fwd) + 8, len(frag))
        wdb = frag[start:stop]
        m = comp_lut[wdb][::-1]
        targets.append(m[m != 255])
        queries.append(codes)
    res = engine.eval_batch(native.HETERO, queries, targets,
                            np.full(len(queries), conc, dtype=np.float32))
    passes = (res["tm"] >= min_tm)
    kept = out["keep"]
    # conservative: every exact pass is kept
    assert np.all(kept[passes]), np.nonzero(passes & ~kept)
    # and useful: most exact-failures are dropped
    n_fail = int((~passes).sum())
    if n_fail > 20:
        assert (~kept & ~passes).sum() >= 0.5 * n_fail
    # the planted sites are among the kept
    assert passes.sum() >= 3


def test_device_screen_degenerate_target_conservative(engine):
    """A window containing a degenerate target base (e.g. N) must never be
    screened out: the reference resolves degenerates *optimistically* per
    query base (nuc_cruc.cpp:14-201), so an N inside a binding site can
    complete a perfect duplex, while any fixed-letter approximation of N
    underestimates the duplex stability.  Such windows must be routed to
    the host (needs_host), not screened with approximated codes."""
    rng = np.random.default_rng(11)
    fwd = "TTGACCTAGATATTCAGCAAC"
    frag_s = "".join(rng.choice(list("ACGT"), 20000))
    # plant the site with one N in the middle of the duplex: the exact
    # engine resolves N -> perfect complement, keeping Tm at the
    # perfect-match value
    site = list(fwd)
    site[10] = "N"
    frag_s = frag_s[:5000] + "".join(site) + frag_s[5000 + len(site):]
    frag = C.ASCII_TO_DB[np.frombuffer(frag_s.encode(), np.uint8)]

    w = 7
    conc = 9e-7
    from tntblast_tpu.screen import DeviceScreen
    scr = DeviceScreen(engine, dangle=False)

    # exact Tm of the planted (N-containing) site
    codes = C.ASCII_TO_MELT[np.frombuffer(fwd.encode(), np.uint8)]
    start, stop = 5000 - 4, 5000 + len(fwd) + 4
    win = C.DB_TO_MELT_COMPLEMENT[frag[start:stop]][::-1]
    res = engine.eval_batch(native.HETERO, [codes], [win[win != 255]],
                            np.array([conc], dtype=np.float32))
    exact_tm = float(res["tm"][0])
    assert exact_tm > 50.0  # optimistic resolution keeps it strong

    # screen with min_tm just below the exact Tm: the site is a true hit
    min_tm = exact_tm - 2.0
    conds = scr.conditions({"min_tm": min_tm, "max_dg": 0.0}, conc)
    dg = np.stack([np.asarray(scr._dg_table(T)) for _, T, _ in conds])
    thr = np.array([[ms] for _, _, ms in conds], dtype=np.int32)
    cfg = PanelConfig(word_len=w, num_os=1, max_words=16, wq_max=21,
                      tile_len=32768, cap=1024, num_cond=len(conds))
    panel = DevicePanel(_mk_panel([(fwd, True)], w), cfg, dg, thr)
    out = panel.run_fragment(frag)
    assert not out["overflow"]

    sel = np.nonzero(out["p"] == 5000)[0]
    assert sel.size == 1
    assert out["needs_host"][sel[0]], "degenerate window must go to host"
    assert out["keep"][sel[0]], "true hit wrongly screened out"


def test_packed_payload_n_runs_and_overflow(engine):
    """The 2-bit packed upload must reconstruct N-runs and scattered
    degenerates exactly (seed counts match the host), and a fragment
    whose exception sideband overflows must surface as overflow (host
    fallback), never as silently wrong codes."""
    rng = np.random.default_rng(21)
    frag = rng.integers(0, 4, 30000).astype(np.uint8)
    # long N runs (assembly gaps) + scattered degenerates
    frag[5000:5400] = C.DB_N
    frag[12000:12010] = C.DB_N
    for posn in rng.integers(0, 30000, 30):
        frag[posn] = rng.integers(4, 16)

    fwd = "TTGACCTAGATATTCAGCAAC"
    w = 7
    cfg = PanelConfig(word_len=w, num_os=1, max_words=16, wq_max=21,
                      tile_len=32768, cap=1024, num_cond=1)
    dg = engine.delta_g().astype(np.int32).reshape(1, -1)
    thr = np.full((1, 1), INT_MIN, dtype=np.int32)
    panel = DevicePanel(_mk_panel([(fwd, True)], w), cfg, dg, thr)
    out = panel.run_fragment(frag)
    assert not out["overflow"]

    host_frag = seed.FragmentIndex(frag, w)
    codes = C.ASCII_TO_MELT[np.frombuffer(fwd.encode(), np.uint8)]
    q, t = seed.find_seeds(host_frag, codes, complement=False)
    q, t = seed.unique_diagonal_seeds(q, t)
    assert int(out["counts"][0]) == len(q)

    # exception overflow: more scattered degenerates than EXC_CAP
    frag2 = rng.integers(0, 4, 30000).astype(np.uint8)
    frag2[::9] = rng.integers(4, 16, len(frag2[::9]))   # ~3300 exceptions
    out2 = panel.run_fragment(frag2)
    assert out2["overflow"], "sideband overflow must force host fallback"


def test_seed_table_and_dense_paths_agree(engine):
    """The word-table seeding path (gather + compaction + scatter) and
    the dense compare-loop fallback (selected statically by a dummy
    (1, num_os) table — the gate in DevicePanel) must produce identical
    seeds, counts, and overflow on the same fragment."""
    import functools

    import jax
    import jax.numpy as jnp

    from tntblast_tpu.parallel.device_search import _seed_fragment

    rng = np.random.default_rng(11)
    frag = rng.integers(0, 4, 8192).astype(np.uint8)
    for pos in rng.integers(0, 8192, 20):
        frag[pos] = rng.integers(4, 18)

    fwd = "TTGACCTAGATATTCAGCAAC"
    rev = "GGGAGAGACTCACCCAAAGATC"
    oligos = [(fwd, True), (fwd, False), (rev, True), (rev, False)]
    w = 7
    panel = _mk_panel(oligos, w)
    num_os, max_words, cap, L = 4, 16, 512, 8192

    ow = np.full((num_os, max_words), -1, np.int32)
    w_tab = np.zeros((4 ** w, num_os), np.int32)
    for i, o in enumerate(panel):
        for k, v in enumerate(o["words"]):
            ow[i, k] = v
            w_tab[int(v), i] |= (1 << k)
    dummy = np.zeros((1, num_os), np.int32)

    run = jax.jit(functools.partial(
        _seed_fragment, word_len=w, num_os=num_os, max_words=max_words,
        tile_len=L, cap=cap))
    a = run(jnp.asarray(frag), jnp.int32(L), jnp.asarray(ow),
            jnp.asarray(w_tab))
    b = run(jnp.asarray(frag), jnp.int32(L), jnp.asarray(ow),
            jnp.asarray(dummy))
    names = ["slot", "p", "n_cand", "counts", "overflow", "word",
             "word_valid"]
    for name, x, y in zip(names, a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), name)
    assert int(a[2]) > 0          # the fragment actually has seeds


def test_batch_overflow_does_not_corrupt_batchmates(engine):
    """ADVICE r4 (high): on the dense seeding path (max_words > 31), a
    fragment whose TRUE candidate count exceeds cap must not shift the
    pooled per-slot segment boundaries — a clean batchmate's kept-seed
    list must be identical to running it alone, and the overflowing
    fragment must be flagged for host fallback."""
    rng = np.random.default_rng(33)
    long_oligo = "".join(rng.choice(list("ACGT"), 40))   # 34 words at w=7
    w = 7
    panel = _mk_panel([(long_oligo, True), (long_oligo, False)], w)
    max_words = max(len(p["words"]) for p in panel)
    assert max_words > 31          # forces the dense seeding path gate

    cap = 256
    cfg = PanelConfig(word_len=w, num_os=2, max_words=max_words,
                      wq_max=40, tile_len=16384, cap=cap, num_cond=1)
    dg = engine.delta_g().astype(np.int32).reshape(1, -1)
    thr = np.full((1, 2), INT_MIN, dtype=np.int32)
    dp = DevicePanel(panel, cfg, dg, thr)
    assert dp.args[1].shape[0] == 1  # dense fallback table selected

    # fragment A: tandem repeat of the oligo -> thousands of diagonals
    site = C.ASCII_TO_DB[np.frombuffer(long_oligo.encode(), np.uint8)]
    frag_a = np.tile(site, 16000 // len(site)).astype(np.uint8)
    # fragment B: clean random background + three planted sites
    frag_b = rng.integers(0, 4, 16000).astype(np.uint8)
    for pos in (2000, 7000, 12000):
        frag_b[pos:pos + len(site)] = site

    batch = dp.resolve_fragments(dp.submit_fragments([frag_a, frag_b]))
    alone = dp.resolve_fragments(dp.submit_fragments([frag_b]))[0]

    assert batch[0]["overflow"], "tandem-repeat fragment must overflow"
    assert not batch[1]["overflow"]
    assert not alone["overflow"]
    assert batch[1]["n_kept"] == alone["n_kept"] > 0
    np.testing.assert_array_equal(batch[1]["os_k"], alone["os_k"])
    np.testing.assert_array_equal(batch[1]["p_k"], alone["p_k"])
    np.testing.assert_array_equal(batch[1]["kmin_k"], alone["kmin_k"])
    np.testing.assert_array_equal(batch[1]["counts"], alone["counts"])


def _screen_reference(ptb, ts_slot, ql, wt_e, nc_all, eval_on):
    """Plain numpy transcription of the screening DP for ONE slot's
    windows (B, wt).  Returns (best (nc, B), mgmax (B,), M_rows
    (wq, B, wt)): M rows of the eval condition (the last) with eval_on,
    of the first condition otherwise."""
    NEG = -(1 << 29)
    B, wt = ptb.shape
    wq = ts_slot.shape[0]
    relu = lambda x: np.maximum(x, 0)   # noqa: E731
    prevM = np.full((nc_all, B, wt), -1, np.int64)
    prevIq = prevM.copy()
    prevIt = prevM.copy()
    best = np.full((nc_all, B), -1, np.int64)
    prevMg = np.full((B, wt), NEG, np.int64)
    mgmax = np.full(B, NEG, np.int64)
    col_ok = np.arange(wt)[None, :] < wt_e
    M_rows = np.zeros((wq, B, wt), np.int64)

    def shl(x, fill=-1):
        out = np.full_like(x, fill)
        out[..., 1:] = x[..., :-1]
        return out

    for r in range(wq):
        e = ts_slot[r][ptb]                      # (B, wt, nc*7)
        e = np.moveaxis(e.reshape(B, wt, nc_all, 7), 2, 0)
        dgmm, dgmq, dgmt = e[..., 0], e[..., 1], e[..., 2]
        dgqi, dgqe = e[..., 3], e[..., 4]
        dgti, dgte = e[..., 5], e[..., 6]
        m = np.maximum(
            np.maximum(relu(shl(prevM)) - dgmm, relu(shl(prevIq)) - dgmq),
            relu(shl(prevIt)) - dgmt)
        it = np.maximum(relu(prevM) - dgti, relu(prevIt) - dgte)
        a = np.maximum(relu(shl(m)) - dgqi, -dgqe)
        iq = np.empty_like(a)
        iq[..., 0] = a[..., 0]
        for j in range(1, wt):
            iq[..., j] = np.maximum(a[..., j], iq[..., j - 1] - dgqe[..., j])
        if r < ql:
            best = np.maximum(best,
                              np.where(col_ok[None], m, -1).max(axis=2))
        if eval_on:
            g1 = np.where(shl(prevMg, NEG) >= 0,
                          shl(prevMg, NEG) - dgmm[-1], NEG)
            mg = np.maximum(np.maximum(g1, relu(shl(prevIq[-1])) - dgmq[-1]),
                            relu(shl(prevIt[-1])) - dgmt[-1])
            if r < ql:
                mgmax = np.maximum(
                    mgmax, np.where(col_ok, mg, NEG).max(axis=1))
            prevMg = mg
            M_rows[r] = m[-1]
        else:
            M_rows[r] = m[0]
        prevM, prevIq, prevIt = m, iq, it
    return best, mgmax, M_rows


def _check_screen_dp(seed_val, n_real, wq_max, wt_max, nc_all, B, eval_on):
    """screen_dp (jitted, on the default device) against the numpy
    recurrence on random mixed-slot windows: best scores of every
    condition, and with eval_on the gapped-best channel and every real M
    row, all exactly."""
    import functools

    import jax

    from tntblast_tpu.parallel.device_search import screen_dp

    rng = np.random.default_rng(seed_val)
    ts = rng.integers(-60000, 60000,
                      (n_real, wq_max, 30, nc_all * 7)).astype(np.int32)
    ql_slot = rng.integers(max(4, wq_max - 6), wq_max + 1, n_real)
    # slot n_real is pool padding: zero energies, ql 1
    sl = rng.integers(0, n_real + 1, B).astype(np.int32)
    ql_all = np.append(ql_slot, 1).astype(np.int32)
    ql = ql_all[sl]
    wt_e = (ql + 8).astype(np.int32)
    ptb = rng.integers(0, 30, (B, wt_max)).astype(np.int32)

    run = jax.jit(functools.partial(screen_dp, eval_on=eval_on))
    best, mgmax, mrows = (np.asarray(x) for x in run(
        ptb, sl, ql, wt_e, ts.astype(np.float32)))
    assert best.shape == (nc_all, B)
    assert mrows.shape == (wq_max, B, wt_max + 1)

    ts_pad = np.concatenate([ts, np.zeros_like(ts[:1])]).astype(np.int64)
    for s in range(n_real + 1):
        sel = np.flatnonzero(sl == s)
        if sel.size == 0:
            continue
        q = int(ql_all[s])
        rb, rmg, rM = _screen_reference(ptb[sel], ts_pad[s], q, q + 8,
                                        nc_all, eval_on)
        np.testing.assert_array_equal(best[:, sel], rb, f"best slot {s}")
        if eval_on:
            np.testing.assert_array_equal(mgmax[sel], rmg, f"mg slot {s}")
            np.testing.assert_array_equal(mrows[:q, sel, 1:], rM[:q],
                                          f"M rows slot {s}")


@pytest.mark.parametrize("eval_on", [False, True])
def test_screen_dp_matches_numpy(eval_on):
    _check_screen_dp(5, n_real=5, wq_max=12, wt_max=20,
                     nc_all=3 if eval_on else 2, B=300, eval_on=eval_on)


@pytest.mark.gpu
def test_screen_dp_matches_numpy_on_gpu(gpu):
    """The same check on the card at bench widths: 24-nt oligos, 32-column
    windows, two screening conditions plus the eval condition, one full
    screen chunk of windows over 40 slots."""
    from tntblast_tpu.parallel.device_search import SCREEN_CHUNK
    _check_screen_dp(6, n_real=40, wq_max=24, wt_max=32, nc_all=3,
                     B=SCREEN_CHUNK, eval_on=True)


@pytest.mark.gpu
def test_panel_step_gpu_matches_cpu(gpu, engine):
    """The whole panel step (seeding, pooling, screen, device eval,
    compaction) on the card must return exactly what the CPU backend
    returns for the bench panel on bench-sized fragments."""
    import os

    import jax

    import bench_data
    from tntblast_tpu.model import (
        expand_degenerate_signatures, read_input_file)
    from tntblast_tpu.options import Options
    from tntblast_tpu.parallel.panel import FragmentPanelManager

    work = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bench_work")
    fna, panel_path = bench_data.build(work)
    opt = Options()
    opt.parse(["-i", panel_path, "-d", fna, "-A", "PCR", "-e", "40",
               "-E", "45", "-l", "2000", "-o", os.devnull])
    opt.sig_list = expand_degenerate_signatures(
        read_input_file(opt.input_filename, opt.ignore_probe, False),
        opt.degen_rescale_ct)
    mgr = FragmentPanelManager(opt, engine)
    rng = np.random.default_rng(bench_data.SEED)
    frags = [rng.integers(0, 4, 500_000).astype(np.uint8) for _ in range(2)]
    # planted amplicon sites make kept windows and device-evaluated hits
    for f in frags:
        for sig in opt.sig_list[:bench_data.NPLANT]:
            fw = C.ASCII_TO_DB[np.frombuffer(sig.forward_oligo.encode(),
                                             np.uint8)]
            rv = C.ASCII_TO_DB[np.frombuffer(sig.reverse_oligo.encode(),
                                             np.uint8)]
            rc = bench_data._revcomp(rv)
            for pos in rng.integers(0, 490_000, 6):
                f[pos:pos + len(fw)] = fw
                f[pos + 150 - len(rc):pos + 150] = rc
    g = mgr.groups[0]
    dp = g.device_panel(mgr._tile_len(500_000))
    on_gpu = [np.asarray(x) for x in dp.submit_fragments(frags)[1]]
    with jax.default_device(jax.devices("cpu")[0]):
        on_cpu = [np.asarray(x) for x in dp.submit_fragments(frags)[1]]
    assert int(on_gpu[0][0]) > 0
    for name, a, b in zip(["header", "kept"], on_gpu, on_cpu):
        np.testing.assert_array_equal(a, b, name)
