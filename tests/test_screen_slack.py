"""The screen-soundness slack property (screen.py, screen_bound.py).

The screen drops a window when the SCREENING-table DP (admissible event
charges, update_dp_param_screen) fails a threshold minus the
constructive slack bound; soundness requires

    dG_exact(reported alignment, T)  >=  screen_dp(T) - slack(T)

for every window, at every screening temperature, in every engine mode —
including --dinkelbach, where the reported alignment is optimized at a
different temperature (the iteration changes WHICH alignment is
reported, not the evaluator; the inequality is over all alignments).

This regression corpus hammers the inequality on structured windows:
internal loops, bulges on either strand, frayed ends, GT/TG wobble runs,
dangling ends, across the screening temperature range, plus Dinkelbach
checked against independently-computed screen_dp(T*) and screen_dp(Tk).
The constructive per-family derivation lives in screen_bound.py /
tests/test_screen_bound.py; this corpus is the end-to-end check that the
derivation composes on realistic multi-event windows.
"""

import numpy as np
import pytest

from tntblast_tpu import native
from tntblast_tpu.screen import DeviceScreen

RNG = np.random.default_rng(20260820)
COMP = {0: 3, 1: 2, 2: 1, 3: 0}


def _mutate(codes, positions):
    out = codes.copy()
    for p in positions:
        out[p] = (out[p] + 1 + RNG.integers(0, 3)) % 4
    return out


def _corpus(n_oligos=10):
    """[(oligo_codes, window_codes)] — window is the melt-code target the
    oligo aligns to (perfect complement = the oligo itself in this code
    space, as eval_batch aligns query vs reversed-complement windows)."""
    items = []
    for i in range(n_oligos):
        L = int(RNG.integers(18, 31))
        oligo = RNG.integers(0, 4, L).astype(np.uint8)
        if i % 3 == 0:
            # AT-rich ends: exercises AT-closing / bulge-AT corrections
            oligo[:2] = RNG.integers(0, 2, 2) * 3
            oligo[-2:] = RNG.integers(0, 2, 2) * 3
        perfect = oligo.copy()

        wins = [perfect]
        # scattered mismatches
        for k in (1, 2, 3, 5):
            wins.append(_mutate(perfect, RNG.choice(L, k, replace=False)))
        # clustered mismatches -> internal loops of size 2..8
        for k in (2, 3, 4):
            s = int(RNG.integers(4, L - k - 4))
            wins.append(_mutate(perfect, range(s, s + k)))
        # two separate loops
        w = _mutate(perfect, range(4, 6))
        wins.append(_mutate(w, range(L - 7, L - 5)))
        # bulges: insertions in the target
        for k in (1, 2, 3):
            s = int(RNG.integers(5, L - 5))
            ins = RNG.integers(0, 4, k).astype(np.uint8)
            wins.append(np.concatenate([perfect[:s], ins, perfect[s:]]))
        # bulges: deletions from the target (query-side bulge)
        for k in (1, 2):
            s = int(RNG.integers(5, L - 5 - k))
            wins.append(np.concatenate([perfect[:s], perfect[s + k:]]))
        # frayed ends
        wins.append(_mutate(perfect, [0, 1, L - 2, L - 1]))
        # loop + bulge combined (asymmetric internal loop)
        s0 = int(RNG.integers(6, L - 8))
        w = _mutate(perfect, range(s0, s0 + 2))
        wins.append(np.concatenate(
            [w[:s0 + 2], RNG.integers(0, 4, 2).astype(np.uint8),
             w[s0 + 2:]]))
        # bulge adjacent to an end (stresses terminal handling)
        wins.append(np.concatenate(
            [perfect[:3], RNG.integers(0, 4, 1).astype(np.uint8),
             perfect[3:]]))
        # GT/TG wobble run (special double-mismatch parameters)
        w = perfect.copy()
        for p in range(6, 10):
            w[p] = 2 if oligo[p] == 3 else (3 if oligo[p] == 2 else w[p])
        wins.append(w)
        # flanked windows (binding site inside a larger window)
        flank = RNG.integers(0, 4, 4).astype(np.uint8)
        wins.append(np.concatenate([flank, perfect, flank]))
        # pure random
        wins.append(RNG.integers(0, 4, L + 8).astype(np.uint8))

        items.extend((oligo, w) for w in wins)
    return items


CORPUS = _corpus()
CONC = 9e-7


def _screen_dp_dg(engine, items, T):
    """Screening-table DP free energy per window at temperature T."""
    from tntblast_tpu.ops.thermo_dp import dp_max_score
    dg = engine.delta_g_screen(np.float32(T)).astype(np.int32).reshape(-1)
    wq = max(len(o) for o, _ in items)
    wt = max(len(w) for _, w in items)
    n = len(items)
    qc = np.zeros((n, wq), np.int32)
    ql = np.zeros(n, np.int32)
    tc = np.zeros((n, wt), np.int32)
    tl = np.zeros(n, np.int32)
    for i, (o, w) in enumerate(items):
        qc[i, :len(o)] = o
        ql[i] = len(o)
        tc[i, :len(w)] = w
        tl[i] = len(w)
    score = np.asarray(dp_max_score(qc, ql, tc, tl, dg, wq=wq, wt=wt))
    return -score.astype(np.float64) / 10000.0


def _gaps(engine, items):
    """screen_dp(T*) - exact_dg per corpus window (positive = the exact
    evaluator beat the screening bound by that much)."""
    q = [o for o, _ in items]
    t = [w for _, w in items]
    out = engine.eval_batch(native.HETERO, q, t,
                            np.full(len(items), CONC, dtype=np.float32))
    ok = out["valid"].astype(bool)
    sdp = _screen_dp_dg(engine, items, float(engine.target_T))
    return (sdp[ok] - out["dg"][ok]), out


@pytest.mark.parametrize("target_T", [290.15, 310.15, 330.15])
def test_slack_bound_plain(target_T):
    from tntblast_tpu.screen_bound import slack_bound
    eng = native.MeltEngine(target_T=target_T, n_threads=1)
    gaps, _ = _gaps(eng, CORPUS)
    assert len(gaps) > 0.5 * len(CORPUS)
    assert gaps.max() <= slack_bound(eng, target_T, False), float(gaps.max())


def test_slack_bound_dangle():
    from tntblast_tpu.screen_bound import slack_bound
    eng = native.MeltEngine(dangle5=True, dangle3=True, n_threads=1)
    gaps, _ = _gaps(eng, CORPUS)
    assert len(gaps) > 0.5 * len(CORPUS)
    assert gaps.max() <= slack_bound(eng, 310.15, True), float(gaps.max())


def test_slack_bound_dinkelbach():
    """Dinkelbach reports an alignment optimized at T=Tm; the screen's two
    conditions compare it against dp(T*) and dp(Tk) computed at fixed
    temperatures — verify both inequalities directly."""
    t_star = 310.15
    min_tm = 40.0
    tk = min_tm + 273.15

    dink = native.MeltEngine(target_T=t_star, dinkelbach=True, n_threads=1)
    ref_star = native.MeltEngine(target_T=t_star, n_threads=1)
    ref_tk = native.MeltEngine(target_T=tk, n_threads=1)

    q = [o for o, _ in CORPUS]
    t = [w for _, w in CORPUS]
    conc = np.full(len(CORPUS), CONC, dtype=np.float32)
    out_d = dink.eval_batch(native.HETERO, q, t, conc)
    out_s = ref_star.eval_batch(native.HETERO, q, t, conc)
    out_k = ref_tk.eval_batch(native.HETERO, q, t, conc)

    ok = out_d["valid"].astype(bool)
    assert ok.sum() > 0.5 * len(CORPUS)
    from tntblast_tpu.screen_bound import slack_bound
    # dG condition: reported dG vs screen_dp(T*)
    sdp_star = _screen_dp_dg(dink, CORPUS, t_star)
    gap_dg = sdp_star[ok] - out_d["dg"][ok]
    assert gap_dg.max() <= slack_bound(dink, t_star, False), \
        float(gap_dg.max())
    # Tm condition: dH - Tk*dS of the reported alignment vs screen_dp(Tk)
    sdp_tk = _screen_dp_dg(dink, CORPUS, tk)
    dg_at_tk = out_d["dH"][ok] - np.float32(tk) * out_d["dS"][ok]
    gap_tm = sdp_tk[ok] - dg_at_tk
    assert gap_tm.max() <= slack_bound(dink, tk, False), \
        float(gap_tm.max())


def test_dinkelbach_screen_active_and_prunes():
    """--dinkelbach no longer disables the screen: conditions() must be
    non-empty and the e2e dinkelbach screen config must actually prune
    (the pcr_dinkelbach golden-parity run is in test_e2e_screen.py)."""
    eng = native.MeltEngine(dinkelbach=True, n_threads=1)
    scr = DeviceScreen(eng)
    conds = scr.conditions({"min_tm": 40.0, "max_dg": 100.0}, CONC)
    assert conds, "screen disabled under dinkelbach"
    assert any(tag == "tm" for tag, _, _ in conds)
