"""Device-side candidate screening (the device fast path).

The reference evaluates every seeded window with the full DP + co-optimal
enumeration + exact re-scoring cascade (reference bind_oligo.cpp:124-454).
Almost all windows fail the Tm/dG filters; the device pipeline discards them
with one batched device DP before the exact (bit-reproducing) engine ever
sees them.

Correctness argument (so the screened pipeline stays bit-identical):

  A reported hit must satisfy Tm >= min_tm and dG <= max_dg.  With
  Tk = min_tm + 273.15 and Ct the oligo strand concentration,

      Tm >= min_tm  <=>  dG_alignment(Tk) <= Tk * R * ln(Ct)

  (identical algebra to the reference Tm formula, nuc_cruc.cpp:2284-2297).
  The screen runs the DP over a SCREENING table in which every event the
  exact re-scorer (evaluate_alignment) may re-price — loops, bulges,
  terminal swaps — is charged an admissible LOWER bound (0), so the
  screening path energy never overcharges any alignment the re-scorer
  could produce.  The residual slack (per-alignment boundary effects the
  table cannot express: AT-closing, init terms, salt-count rounding) is
  bounded CONSTRUCTIVELY from the parameter tables themselves
  (screen_bound.slack_bound; derivation in docs/screen_bound.md).  Hence
  every window that can produce a hit satisfies

      dp_screen(Tk) - slack <= dG_alignment(Tk) <= Tk*R*ln(Ct)
      dp_screen(T*) - slack <= dG_alignment(T*) <= max_dg

  and a window failing either inequality is provably hit-free and is
  dropped without exact evaluation.  Windows are never dropped on the
  max_tm / min_dg / clamp / mismatch sides (dropping is only ever done on
  conditions every survivor must satisfy).

  NOTE an earlier (rounds 1-3) screen ran over the EXACT dp table with a
  corpus-fitted constant slack (4.0/7.0 kcal/mol); that argument was
  UNSOUND — a mismatch cluster routed through gap pairs overcharges the
  exact-table path linearly in cluster size, so no constant slack exists
  (docs/screen_bound.md records the counterexample).  Do not revive it.
"""

import math

import numpy as np

from tntblast_tpu import constants as C

R_GAS = float(np.float32(1.9872e-3))


class ScreenStub:
    """Cache sentinel for a screened-out window: records the filter bounds
    the screen proof was run against so later lookups with *weaker* bounds
    trigger exact evaluation instead of reusing the proof."""

    __slots__ = ("min_tm", "max_dg", "conc", "fail_tm", "fail_dg")

    def __init__(self, min_tm, max_dg, conc, fail_tm, fail_dg):
        self.min_tm = min_tm
        self.max_dg = max_dg
        self.conc = conc
        self.fail_tm = fail_tm
        self.fail_dg = fail_dg

    def covers(self, filt, conc):
        if self.fail_tm and conc == self.conc and filt["min_tm"] >= self.min_tm:
            return True
        if self.fail_dg and filt["max_dg"] <= self.max_dg:
            return True
        return False


class DeviceScreen:
    """Batched DP screen bound to one native engine's parameter tables.

    The DP runs over the SCREENING table (update_dp_param_screen: event
    charges replaced by admissible lower bounds) and the slack is the
    constructive bound computed from the tables (screen_bound.py) — the
    previous corpus-fitted constants 4.0/7.0 were violated by mismatch
    clusters routed through gap pairs (docs/screen_bound.md)."""

    def __init__(self, engine, dangle=False, min_batch=64):
        from tntblast_tpu.screen_bound import slack_bound
        self.engine = engine
        self.dangle = dangle
        # max over the operating range (screening temperatures land in
        # [Tk_min, T*]; the bound is near-constant in T)
        self.slack = max(slack_bound(engine, t, dangle)
                         for t in (273.15, 293.15, 313.15, 333.15,
                                   353.15, 373.15)) + 0.1
        self.min_batch = min_batch
        self._tables = {}   # round(T,4) -> device int32 (2401,)
        t = engine._tables
        self._init_H = float(t.param_init_H)
        self._init_S = float(t.param_init_S)
        self.stats = {"screened": 0, "kept": 0, "batches": 0}

    def _dg_table(self, T):
        import jax.numpy as jnp
        key = round(float(T), 4)
        tab = self._tables.get(key)
        if tab is None:
            tab = jnp.asarray(
                self.engine.delta_g_screen(
                    np.float32(T)).astype(np.int32).reshape(-1))
            self._tables[key] = tab
        return tab

    def _init_dg(self, T):
        return self._init_H - float(T) * self._init_S

    def conditions(self, filt, conc):
        """[(tag, T, min_score)] — a surviving window needs DP score >=
        min_score at every temperature T (int fixed-point, x10000).

        The bound is alignment-agnostic, so it covers --dinkelbach too:
        the Dinkelbach iteration (reference nuc_cruc.cpp:2399-2440) only
        changes WHICH alignment A* of the window gets reported, never the
        evaluator.  The reported Tm/dG still come from evaluate_alignment
        on A*, hence  dG_exact(A*, T) >= path(A*, T) - slack >= dp(T) -
        slack  at every screening temperature T: the same two conditions
        remain necessary for a hit (test_screen_slack_property covers
        adversarial loop/bulge/frayed/dangling alignments at multiple
        temperatures)."""
        conds = []
        if filt["min_tm"] > 0 and conc > 0:
            tk = filt["min_tm"] + 273.15
            bound = tk * R_GAS * math.log(conc) + self.slack
            ms = int(math.ceil((self._init_dg(tk) - bound) * 10000.0))
            if ms > 0:
                conds.append(("tm", tk, ms))
        tstar = float(self.engine.target_T)
        bound = filt["max_dg"] + self.slack
        ms = int(math.ceil((self._init_dg(tstar) - bound) * 10000.0))
        if ms > 0:
            conds.append(("dg", tstar, ms))
        return conds

    def screen_windows(self, oligo_codes, window_codes, filt, conc):
        """(keep, fail_tm, fail_dg) masks over windows.  window_codes: list
        of uint8 melt-code arrays (already strand-oriented)."""
        conds = self.conditions(filt, conc)
        n = len(window_codes)
        fail_tm = np.zeros(n, dtype=bool)
        fail_dg = np.zeros(n, dtype=bool)
        if not conds or n == 0:
            return np.ones(n, dtype=bool), fail_tm, fail_dg

        import jax.numpy as jnp
        from tntblast_tpu.ops.thermo_dp import dp_max_score

        wq = len(oligo_codes)
        wt = wq + 2 * C.NUM_FLANK_BASE
        B = max(self.min_batch, 1 << (n - 1).bit_length())

        qc = np.zeros((B, wq), dtype=np.int32)
        qc[:] = oligo_codes.astype(np.int32)
        ql = np.full(B, wq, dtype=np.int32)
        tc = np.zeros((B, wt), dtype=np.int32)
        tl = np.zeros(B, dtype=np.int32)
        for i, w in enumerate(window_codes):
            m = min(len(w), wt)
            tc[i, :m] = w[:m]
            tl[i] = m

        keep = np.ones(n, dtype=bool)
        qc_d, ql_d = jnp.asarray(qc), jnp.asarray(ql)
        tc_d, tl_d = jnp.asarray(tc), jnp.asarray(tl)
        for tag, T, min_score in conds:
            score = dp_max_score(qc_d, ql_d, tc_d, tl_d, self._dg_table(T),
                                 wq=wq, wt=wt)
            failed = np.asarray(score[:n]) < min_score
            keep &= ~failed
            # A ScreenStub must only claim the proof that actually fired.
            if tag == "dg":
                fail_dg |= failed
            else:
                fail_tm |= failed
        self.stats["batches"] += 1
        self.stats["kept"] += int(keep.sum())
        self.stats["screened"] += int(n - keep.sum())
        return keep, fail_tm, fail_dg

    def make_stub(self, filt, conc, failed_tm, failed_dg):
        return ScreenStub(filt["min_tm"], filt["max_dg"], conc,
                          fail_tm=bool(failed_tm), fail_dg=bool(failed_dg))
