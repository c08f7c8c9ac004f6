"""Host-side bookkeeping for block-paged KV pools (port of
``repro.serve.paging``, numpy only): a fixed pool of ``n_pages``
fixed-size blocks per cache leaf, a per-slot page table, refcounted prefix
sharing, and copy-on-write.

Device memory holds ONE pool tensor per cache leaf and layer, shaped
``(n_pages, KVH, page_size, hd)``; a cascade tier stacks E member planes
under the same table (members score the same tokens at the same positions,
so every shared page is an E-fold saving).  This module owns only the
*table*: which pool page backs which ``page_size``-token span of which
slot.  Allocation decisions are host control flow.

Layout contract (what makes paged == dense bitwise):

* ``page_size`` must divide ``max_seq``; a slot's gathered view is always
  exactly ``pages_per_slot * page_size == max_seq`` rows, so the attention
  reduction runs over the same S lanes in the same order as the dense slot
  cache.  Unmapped (-1) table entries read as zero rows; they are masked
  to exactly ``-1e30`` logits, whose softmax weight underflows to exactly
  0.0 — the same mechanism that hides a dense slot's stale rows.
* the last pool page is a sacrificial overflow sink, never allocated: a
  decode write against an unmapped row (an inactive slot, or a slot being
  force-completed this step) lands there harmlessly.

Prefix sharing: at admission, the prompt's leading FULL pages are keyed by
a crc32 chain over their tokens (deterministic across processes) and
looked up in the pool's prefix index.  A hit increments the page's
refcount instead of allocating; a miss allocates and registers the page
once its contents are written (chunked prefill writes the whole prefix
before any sharer can be admitted, and device work runs in launch order,
so a sharer's reads always see the owner's writes).  Decode-only admission
skips sharing — its prefix pages fill one token per step.

Copy-on-write: a slot never writes a page it shares (``refcount > 1``) —
``prepare`` hands the backend a (src, dst) device copy and repoints the
slot's table entry first.  In the serving flow this cannot trigger, but it
keeps the pool correct under any direct write pattern; ``prepare`` also
unregisters a solo-owned registered page before its owner writes into it.
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import Observability, StatsView


def prefix_page_keys(tokens, page_size: int, n_pages: int) -> List[int]:
    """Chain-crc32 keys for the first ``n_pages`` full pages of a prompt:
    key i digests tokens[0 : (i+1)*page_size], so equal keys mean equal
    whole prefixes (not just equal pages at the same index)."""
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32)).astype("<i4")
    keys, crc = [], 0
    for i in range(n_pages):
        crc = zlib.crc32(toks[i * page_size : (i + 1) * page_size].tobytes(), crc)
        keys.append(crc)
    return keys


class PagePool:
    """Free-list page allocator + per-slot page table + prefix index.

    ``table`` is the (n_slots, pages_per_slot) int32 page-table array the
    decode/prefill programs consume directly (-1 = unmapped); it is plain
    numpy, copied to the device once per decode step.
    """

    def __init__(self, n_pages: int, page_size: int, *, n_slots: int,
                 max_seq: int, obs: Optional[Observability] = None,
                 name: str = "paging"):
        if max_seq % page_size != 0:
            raise ValueError(
                f"page_size {page_size} must divide max_seq {max_seq} "
                "(the gathered slot view must be exactly max_seq rows)"
            )
        if n_pages < 2:
            raise ValueError(f"need >= 2 pages (1 overflow sink), got {n_pages}")
        self.n_pages = n_pages
        self.page_size = page_size
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.pages_per_slot = max_seq // page_size
        self.overflow_page = n_pages - 1  # sacrificial sink, never allocated
        self.table = np.full((n_slots, self.pages_per_slot), -1, np.int32)
        self.refcount = np.zeros(n_pages, np.int32)
        # LIFO free list over the allocatable pages [0, n_pages - 1)
        self._free: List[int] = list(range(n_pages - 2, -1, -1))
        self._prefix_index: Dict[int, int] = {}  # chain key -> page
        self._page_key: Dict[int, int] = {}  # page -> chain key (registered)
        # registry-backed accounting: counters for the allocator events,
        # gauges for occupancy and cross-slot sharing; ``stats`` is the
        # read-only view over them
        self.obs = obs if obs is not None else Observability.private()
        sc = self.obs.scope(name)
        self._c_allocated = sc.counter("allocated")
        self._c_freed = sc.counter("freed")
        self._c_shared_hits = sc.counter("shared_hits")
        self._c_cow = sc.counter("cow_copies")
        self._c_admit_failures = sc.counter("admit_failures")
        self._g_occupancy = sc.gauge("pool_occupancy")
        self._g_sharing = sc.gauge("shared_pages_saved")
        self.stats = StatsView({
            "allocated": lambda m=self._c_allocated: m.value,
            "freed": lambda m=self._c_freed: m.value,
            "shared_hits": lambda m=self._c_shared_hits: m.value,
            "cow_copies": lambda m=self._c_cow: m.value,
            "admit_failures": lambda m=self._c_admit_failures: m.value,
            "peak_pages_in_use": lambda m=self._g_occupancy: m.peak,
        })

    # -- accounting --------------------------------------------------------
    @property
    def pages_in_use(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def shared_pages_saved(self) -> int:
        """Cross-slot page copies avoided RIGHT NOW: sum of (refcount - 1)
        over shared pages.  Each is additionally an E-fold saving on a tier
        pool — every member plane skips its copy of the page."""
        return int(np.sum(np.maximum(self.refcount - 1, 0)))

    def assert_conserved(self):
        """Refcount conservation: every page's refcount equals its table
        occurrences; free pages are unreferenced and never mapped; the
        overflow sink is never allocated or mapped."""
        counts = np.bincount(
            self.table[self.table >= 0].ravel(), minlength=self.n_pages
        )
        assert np.array_equal(counts, self.refcount), (counts, self.refcount)
        for pg in self._free:
            assert self.refcount[pg] == 0, (pg, self.refcount[pg])
        assert len(set(self._free)) == len(self._free), "free list duplicates"
        assert self.refcount[self.overflow_page] == 0
        assert self.overflow_page not in self._free
        for key, pg in self._prefix_index.items():
            assert self._page_key.get(pg) == key and self.refcount[pg] > 0
        for pg, key in self._page_key.items():
            assert self._prefix_index.get(key) == pg, (pg, key)

    # -- allocator core ----------------------------------------------------
    def _alloc(self) -> Optional[int]:
        if not self._free:
            return None
        pg = self._free.pop()
        self.refcount[pg] = 1
        self._c_allocated.add(1)
        self._g_occupancy.set(self.pages_in_use)
        return pg

    def _unregister(self, pg: int):
        key = self._page_key.pop(pg, None)
        if key is not None:
            del self._prefix_index[key]

    def _decref(self, pg: int):
        assert self.refcount[pg] > 0, pg
        self.refcount[pg] -= 1
        if self.refcount[pg] == 0:
            self._unregister(pg)
            self._free.append(pg)
            self._c_freed.add(1)
            self._g_occupancy.set(self.pages_in_use)

    # -- slot lifecycle ----------------------------------------------------
    def admit(self, slot: int, tokens, *, share: bool = True) -> Optional[int]:
        """Map pages for a new occupant of ``slot``; returns the number of
        prompt tokens covered by shared prefix pages (0 if none), or None
        when the pool cannot cover the prompt — the admission must be
        retried later, the table row is left empty.

        Pages are mapped for positions [0, len(tokens) - 1] inclusive: the
        prompt's prefill span plus the last prompt token's decode write.
        With ``share``, the leading full pages first consult the prefix
        index (hit -> refcount bump) and misses are registered for future
        sharers; ``share=False`` (decode-only admission) always allocates
        private pages and registers nothing."""
        row = self.table[slot]
        assert np.all(row < 0), f"slot {slot} admitted while still mapped"
        ps = self.page_size
        m = len(tokens) - 1  # prefill span; first decode write lands at m
        n_need = m // ps + 1
        n_full = m // ps  # pages fully covered by the prefill span [0, m)
        keys = prefix_page_keys(tokens, ps, n_full) if share else []
        shared = 0
        mapped: List[int] = []  # Python-int mirror of the row being built
        for i, key in enumerate(keys):
            pg = self._prefix_index.get(key)
            if pg is None:
                break
            row[i] = pg
            mapped.append(pg)
            self.refcount[pg] += 1
            shared = i + 1
            self._c_shared_hits.add(1)
            self._g_sharing.set(self.shared_pages_saved())
        for i in range(shared, n_need):
            pg = self._alloc()
            if pg is None:
                # roll the whole admission back; the caller re-queues
                for j in range(i):
                    self._decref(mapped[j])
                    row[j] = -1
                self._c_admit_failures.add(1)
                return None
            row[i] = pg
            mapped.append(pg)
        if share:
            for i in range(shared, n_full):
                # never steal a live entry: a key can already be registered
                # to another page after a defensive unregister broke the
                # chain above it (unreachable in serving, where registered
                # pages never mutate, but the pool stays consistent anyway)
                if keys[i] not in self._prefix_index:
                    self._prefix_index[keys[i]] = mapped[i]
                    self._page_key[mapped[i]] = keys[i]
        return shared * ps

    def extend(self, slot: int, n_rows: int) -> bool:
        """Map PRIVATE pages so rows ``[0, n_rows)`` of ``slot`` are all
        covered — for a pass that writes provisional KV rows past the
        admission span (the speculative verify, ``serve/speculative.py``).
        Extension pages are never
        looked up in, or registered with, the prefix index: their contents
        are provisional until the acceptance decision, so they must not be
        visible to sharers (COW-safety is structural — registration only
        ever covers the admission prefix, which such a pass never writes).

        Returns False (rolling back its OWN allocations only) when the pool
        cannot cover the span; the caller falls back to plain admission."""
        row = self.table[slot]
        mapped = row.tolist()
        n_need = (n_rows - 1) // self.page_size + 1
        assert n_need <= self.pages_per_slot, (n_rows, self.max_seq)
        added: List[Tuple[int, int]] = []  # (table index, page) this call mapped
        for i in range(n_need):
            if mapped[i] >= 0:
                continue
            pg = self._alloc()
            if pg is None:
                for j, old in added:
                    self._decref(old)
                    row[j] = -1
                self._c_admit_failures.add(1)
                return False
            row[i] = pg
            added.append((i, pg))
        return True

    def truncate(self, slot: int, keep_rows: int):
        """Unmap every page of ``slot`` wholly past rows ``[0, keep_rows)``
        — the rollback after ``extend``.  The page holding row ``keep_rows - 1``
        stays mapped (it carries live rows; any stale tail rows inside it
        are pos-masked and overwritten by subsequent decode writes), so the
        gathered view of the kept span is untouched."""
        row = self.table[slot]
        mapped = row.tolist()
        first = 0 if keep_rows <= 0 else (keep_rows - 1) // self.page_size + 1
        for i in range(first, self.pages_per_slot):
            if mapped[i] >= 0:
                self._decref(mapped[i])
                row[i] = -1
        self._g_sharing.set(self.shared_pages_saved())

    def release(self, slot: int):
        """Unmap the slot: decref every page; zero-ref pages return to the
        free list (registered ones leave the prefix index with them)."""
        row = self.table[slot]
        for pg in row.tolist():
            if pg >= 0:
                self._decref(pg)
        row[:] = -1
        self._g_sharing.set(self.shared_pages_saved())

    def prepare(self, slot: int, pos: int) -> Tuple[bool, List[Tuple[int, int]]]:
        """Make position ``pos`` of ``slot`` writable before a decode step.

        Returns (ok, copies): ``ok`` False means the pool is exhausted (the
        slot must be force-completed); ``copies`` lists (src, dst) device
        page copies the backend must execute (copy-on-write splits)."""
        i = pos // self.page_size
        pg = self.table[slot].tolist()[i]
        if pg < 0:
            new = self._alloc()
            if new is None:
                return False, []
            self.table[slot, i] = new
            return True, []
        if self.refcount[pg] > 1:
            new = self._alloc()
            if new is None:
                return False, []
            self.refcount[pg] -= 1  # still shared by the remaining owners
            self.table[slot, i] = new
            self._c_cow.add(1)
            return True, [(pg, new)]
        # solo-owned: if registered, unregister before the owner mutates it
        self._unregister(pg)
        return True, []
