"""Host-side manager for the full-fragment device search.

Maps the expanded assay list onto device "oligo-strand slots" (one slot per
unique (oligo, strand, screen-filter, concentration) tuple), packs them
into DevicePanel groups, and runs the fragment step once per (fragment,
group).  The outputs become pre-screened seed lists consumed by the host
bind/pair layer (search/bind.py) in place of its own hash lookups — in
exactly the reference's seed order (ascending diagonal delta, smallest
word index as representative; reference bind_oligo.cpp:33-47), so the
downstream pipeline stays bit-identical.

Dropping a screened-out candidate before `cull_oligo_match`/`bind_oligo`
is sound: the device verdict is provably conservative (screen.py), i.e. a
dropped window can never pass the Tm/dG filter, so it could never appear
in a bound-oligo list nor enable any primer/probe pairing.  Culling and
dedup therefore see a subset that yields the identical final hit list.
"""

import functools

import numpy as np

from tntblast_tpu import constants as C
from tntblast_tpu.engine import DeviceError
from tntblast_tpu.screen import DeviceScreen
from tntblast_tpu.search import seed
from tntblast_tpu.parallel.device_search import (
    INT_MIN, DevicePanel, PanelConfig)

MAX_SLOTS = 64          # slots per device panel group
MAX_CAP = 1 << 17       # candidate capacity ceiling per call


FILT_FIELDS = ("min_tm", "max_tm", "min_dg", "max_dg", "clamp_5",
               "clamp_3", "max_mm", "max_gap", "max_poly_degen")


def filt9(filt):
    """Canonical 9-tuple of a filter dict (the C ABI filt9 layout)."""
    return tuple(float(filt[f]) for f in FILT_FIELDS)


def slot_key(oligo, minus, filt, conc):
    """One device slot per (oligo, strand, FULL filter, concentration):
    the eval-filtered seed injection prunes seeds under the slot's
    complete cascade, so slots with different clamps/mismatch caps must
    not share (e.g. padlock arm variants of the same oligo)."""
    return (oligo, bool(minus), filt9(filt), float(conc))


def primer_filt_of(opt):
    """Full primer filter (native_assays.search_assay primer_filt)."""
    return dict(min_tm=opt.min_primer_tm, max_tm=opt.max_primer_tm,
                min_dg=opt.min_primer_dg, max_dg=opt.max_primer_dg,
                clamp_5=0, clamp_3=opt.primer_clamp,
                max_mm=opt.max_mismatch, max_gap=opt.max_gap,
                max_poly_degen=opt.max_poly_degen)


def probe_filt_of(opt):
    """Full probe filter (native_assays.search_assay probe_filt)."""
    return dict(min_tm=opt.min_probe_tm, max_tm=opt.max_probe_tm,
                min_dg=opt.min_probe_dg, max_dg=opt.max_probe_dg,
                clamp_5=opt.probe_clamp_5, clamp_3=opt.probe_clamp_3,
                max_mm=opt.max_mismatch, max_gap=opt.max_gap,
                max_poly_degen=opt.max_poly_degen)


def collect_slots(opt):
    """Every (oligo, strand, filter, conc) the search will seed, deduped.

    Mirrors the call sites in search/assays.py (which mirror
    amplicon_search.cpp / probe_search.cpp / padlock_search.cpp).
    """
    slots = {}

    def add(oligo, minus, filt, conc):
        if not oligo:
            return
        k = slot_key(oligo, minus, filt, conc)
        if k not in slots:
            slots[k] = dict(oligo=oligo, minus=bool(minus), filt=dict(filt),
                            conc=float(conc))

    pf = primer_filt_of(opt)
    bf = probe_filt_of(opt)
    strands = []
    if opt.target_strand & C.SEQ_STRAND_MINUS:
        strands.append(True)
    if opt.target_strand & C.SEQ_STRAND_PLUS:
        strands.append(False)

    for sig in opt.sig_list:
        if sig.has_primers():
            fconc = opt.forward_primer_strand / sig.forward_degen
            rconc = opt.reverse_primer_strand / sig.reverse_degen
            if opt.assay_format == C.ASSAY_PCR:
                for minus in (True, False):
                    add(sig.forward_oligo, minus, pf, fconc)
                    add(sig.reverse_oligo, minus, pf, rconc)
                if sig.has_probe():
                    pconc = opt.probe_strand / sig.probe_degen
                    for minus in (True, False):
                        add(sig.probe_oligo, minus, bf, pconc)
            elif opt.assay_format in (C.ASSAY_PADLOCK, C.ASSAY_MIPS):
                # arm-specific ligation clamps (frag_search search_padlock:
                # upstream arm clamp_3=0, downstream arm clamp_5=0)
                up_filt = dict(bf, clamp_3=0)
                down_filt = dict(bf, clamp_5=0)
                for minus in strands:
                    add(sig.reverse_oligo, minus, up_filt, rconc)
                    add(sig.forward_oligo, minus, down_filt, fconc)
        elif sig.has_probe():
            pconc = opt.probe_strand / sig.probe_degen
            for minus in strands:
                add(sig.probe_oligo, minus, bf, pconc)
    return list(slots.items())


class PanelGroup:
    """<= MAX_SLOTS slots sharing one set of screening conditions."""

    def __init__(self, items, screen, word_len, eval_dg=None,
                 thermo_tables=None):
        self.eval_dg = eval_dg
        self.thermo_tables = thermo_tables
        self.keys = [k for k, _ in items]
        self.slots = [v for _, v in items]
        self.word_len = word_len
        self.screen = screen

        self.panel = []
        cond_ts = []
        per_slot_conds = []
        for s in self.slots:
            codes = C.ASCII_TO_MELT[
                np.frombuffer(s["oligo"].encode(), np.uint8)]
            words = seed.oligo_word_list(codes, word_len,
                                         complement=not s["minus"])
            self.panel.append(
                {"words": words, "codes": codes, "minus": s["minus"]})
            conds = screen.conditions(s["filt"], s["conc"])
            per_slot_conds.append(conds)
            for _, T, _ in conds:
                t = round(float(T), 4)
                if t not in cond_ts:
                    cond_ts.append(t)

        self.cond_ts = cond_ts
        n = len(self.slots)
        self.thresholds = np.full((max(len(cond_ts), 1), n), INT_MIN,
                                  dtype=np.int32)
        for i, conds in enumerate(per_slot_conds):
            for _, T, ms in conds:
                self.thresholds[cond_ts.index(round(float(T), 4)), i] = ms
        self.dg_tables = (
            np.stack([np.asarray(screen._dg_table(t)) for t in cond_ts])
            if cond_ts else
            np.zeros((1, 49 * 49), dtype=np.int32))

        self.wq_max = max(len(p["codes"]) for p in self.panel)
        self.max_words = max(max((len(p["words"]) for p in self.panel),
                                 default=1), 1)
        self.num_os = -(-n // 8) * 8
        self._panels = {}   # tile_len -> DevicePanel

    def device_panel(self, tile_len, mesh=None):
        dp = self._panels.get(tile_len)
        if dp is None:
            # Expected seed-diagonal count on random sequence is
            # sum_slots tile * n_words(slot) / 4^w; size the fixed
            # candidate capacity at ~2x that (the variance of the sum is
            # small).  Overflow falls back to host seeding per group.
            # The chunked DP skips all-padding chunks, so a generous cap
            # costs memory, not compute.
            total_words = sum(len(p["words"]) for p in self.panel)
            expected = tile_len * total_words // 4 ** self.word_len
            cap = min(MAX_CAP, max(2 * expected + 1024, 2048))
            cfg = PanelConfig(
                word_len=self.word_len, num_os=self.num_os,
                max_words=self.max_words, wq_max=self.wq_max,
                tile_len=tile_len, cap=cap,
                num_cond=max(len(self.cond_ts), 1),
                # no screening conditions -> everything is "kept"; the
                # compacted list must hold every candidate
                kcap=cap if not self.cond_ts else None)
            ev_kw = {}
            if self.eval_dg is not None:
                ev_kw = dict(eval_dg=self.eval_dg,
                             thermo_tables=self.thermo_tables)
            if mesh is not None:
                from tntblast_tpu.parallel.mesh import MeshPanel
                dp = MeshPanel(self.panel, cfg, self.dg_tables,
                               self.thresholds, mesh=mesh, **ev_kw)
            else:
                dp = DevicePanel(self.panel, cfg, self.dg_tables,
                                 self.thresholds, **ev_kw)
            self._panels[tile_len] = dp
        return dp


def _device_call(fn):
    """Raise any failure of a device call as DeviceError, naming the
    platform and the reason."""
    @functools.wraps(fn)
    def call(self, *args):
        try:
            return fn(self, *args)
        except Exception as e:
            raise DeviceError(f"device path failed on {self.platform}: "
                              f"{type(e).__name__}: {e}") from e
    return call


class FragmentPanelManager:
    """Runs the device panel for each fragment; yields pre-screened seeds.

    With `mesh` set (a jax.sharding.Mesh), fragment batches shard across
    the mesh's devices (parallel/mesh.py) — the multi-chip equivalent of
    the reference's master/worker database segmentation
    (tntblast_master.cpp:429-511); `batch` tells the caller how many
    fragments to aggregate per submission."""

    MIN_TILE = 1 << 14
    # Fragments aggregated per device launch on a single device: amortizes
    # the fixed per-call dispatch cost over many fragments.  Not yet
    # measured on the GPU (sizing it from tile and memory is open work).
    SINGLE_CHIP_BATCH = 8

    def __init__(self, opt, engine, mesh=None):
        import os as _os
        import threading as _threading
        import jax
        self.platform = jax.default_backend()
        self.screen = DeviceScreen(
            engine, dangle=opt.allow_dangle_5 or opt.allow_dangle_3)
        self.word_len = opt.hash_word_size
        self.mesh = mesh
        if mesh is not None:
            self.batch = int(mesh.devices.size)
        else:
            env = _os.environ.get("TNTBLAST_TPU_BATCH")
            self.batch = int(env) if env else self.SINGLE_CHIP_BATCH
        items = collect_slots(opt)
        # device gapless evaluation: only sound with dangling ends off
        # (the evaluator does not model the dangle/frayed attachment,
        # ops/eval_gapless.py) and outside Dinkelbach mode (the reported
        # alignment is re-scored at varying T there)
        ev_dg = None
        ev_tabs = None
        if (not (opt.allow_dangle_5 or opt.allow_dangle_3)
                and not opt.use_dinkelbach
                and _os.environ.get("TNTBLAST_TPU_DEV_EVAL", "1") != "0"):
            ev_dg = np.ascontiguousarray(
                engine.delta_g().astype(np.int32).reshape(-1))
            ev_tabs = engine._tables
        self.groups = [
            PanelGroup(items[i:i + MAX_SLOTS], self.screen, self.word_len,
                       eval_dg=ev_dg, thermo_tables=ev_tabs)
            for i in range(0, len(items), MAX_SLOTS)]
        self.stats = {"fragments": 0, "seeds": 0, "kept": 0, "fallback": 0}
        # stats are bumped from concurrent batch-resolve threads
        self.stats_lock = _threading.Lock()

    def _tile_len(self, n):
        t = self.MIN_TILE
        while t < n:
            t <<= 1
        return t

    @_device_call
    def submit(self, frag_codes):
        """Enqueue the device step for every panel group (async); pass
        the returned pending object to `resolve`.  Submissions are cheap
        (JAX dispatch); device compute overlaps host search of earlier
        fragments."""
        tile = self._tile_len(len(frag_codes))
        self.stats["fragments"] += 1
        out = []
        for g in self.groups:
            dp = g.device_panel(tile, mesh=self.mesh)
            pend = (dp.submit_fragments([frag_codes]) if self.mesh
                    else dp.submit_fragment(frag_codes))
            out.append((g, dp, pend))
        return out

    @_device_call
    def submit_batch(self, frag_code_list):
        """Enqueue one batched device step for a batch of fragments: one
        launch per panel group covers up to `batch` fragments (sharded
        across the mesh, or a vmap batch on a single device).  Partial
        batches are padded with empty (inert) fragments so a run only
        ever compiles ONE program shape.  Returns a pending object for
        `resolve_batch`."""
        import numpy as np
        n = len(frag_code_list)
        padded = list(frag_code_list)
        if n < self.batch:
            padded += [np.zeros(0, np.uint8)] * (self.batch - n)
        tile = self._tile_len(max(len(f) for f in frag_code_list))
        self.stats["fragments"] += n
        out = []
        for g in self.groups:
            dp = g.device_panel(tile, mesh=self.mesh)
            out.append((g, dp, dp.submit_fragments(padded)))
        return (n, out)

    @_device_call
    def resolve_batch(self, pending):
        """List of per-fragment slot dicts for a submit_batch call."""
        n, per_group = pending
        outs = [{} for _ in range(n)]
        for g, dp, pend in per_group:
            for i, res in enumerate(dp.resolve_fragments(pend)[:n]):
                self._merge_group(outs[i], g, res)
        return outs

    def _merge_group(self, out, g, res):
        """Fold one group's resolved fragment result into the slot dict:
        slot_key -> (q_off, t_pos, n_screened), kept seeds in reference
        order plus the count the device screen pruned.  A fragment that
        overflowed its candidate (or the batch kept-seed) capacity
        contributes nothing; a slot that overflowed its per-slot segment
        contributes nothing for that slot only — the caller falls back to
        host seeding for the missing slots.

        The resolve contract is the fast kept-only form (os_k/p_k/kmin_k
        + per-slot total counts): screened-out candidates never cross the
        device-to-host link."""
        if res["overflow"]:
            with self.stats_lock:
                self.stats["fallback"] += 1
            return
        os_k = res["os_k"]
        p = res["p_k"].astype(np.int64)
        kmin = res["kmin_k"].astype(np.int64)
        counts = res["counts"]
        evw = res.get("eval")
        slot_over = res.get("slot_overflow")
        n_fb = 0
        with self.stats_lock:
            self.stats["seeds"] += int(counts.sum())
            self.stats["kept"] += len(p)
        for i, key in enumerate(g.keys):
            if slot_over is not None and slot_over[i]:
                n_fb += 1
                continue
            sel = (os_k == i)
            # device order is ascending p; host order is ascending
            # delta = -p (reference sort_by_delta)
            q = kmin[sel][::-1]
            t = (p[sel] + kmin[sel])[::-1]
            ev = evw[:, sel][:, ::-1] if evw is not None else None
            out[key] = (q, t, int(counts[i]) - int(sel.sum()), ev)
        if n_fb:
            with self.stats_lock:
                self.stats["fallback"] += n_fb

    @_device_call
    def resolve(self, pending):
        """Slot dict for a single-fragment submit call."""
        out = {}
        for g, dp, dev_out in pending:
            res = (dp.resolve_fragments(dev_out)[0] if self.mesh
                   else dp.resolve_fragment_fast(dev_out))
            self._merge_group(out, g, res)
        return out

    def run_fragment(self, frag_codes):
        return self.resolve(self.submit(frag_codes))
