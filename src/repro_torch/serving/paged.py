"""Paged KV cache pool: one shared page pool per layer, per-slot block
tables and an on-device free-page stack with refcounts (the port of the
allocator, layout, insertion and prefix-sharing parts of
``repro.serving.paged``).

Layout (per layer; head-major so appends and gathers are flat row
indexing, and one (page, head) pair is one kernel read)::

    k_pages / v_pages : (Hkv, S * num_pages + 1, page_size, hd)
    pos_ids           : (S*B, W) int32  — LOGICAL positions, -1 = empty
    length            : (S*B,)  int32

(a recurrent layer keeps its fixed-size, slot-addressed state instead),
plus ONE shared allocator at ``caches["paged"]`` (every layer of a slot
has identical occupancy, so one block table serves all layers)::

    tbl  : (S, B, max_pages) int32 physical page per logical page, -1 = none
    free : (S, num_pages)    int32 stacks; free[s, :top[s]] are free ids
    top  : (S,)              int32 free-page counts
    ref  : (S, num_pages)    int32 per-page reference counts

S is the number of shards: a single engine's is 1; the fleet
(``serving/sharded.py``) serves S shards of B slots on one device, its
per-slot rows flat, shard s at rows [s*B, (s+1)*B). Each shard's page ids
are its own, 0..P-1 (P = ``num_pages``); shard s's page p is pool page
s*P + p, and ``model_table`` gives the model one (S*B, M) table of pool
page ids. The pool's last page, S*P, is the TRASH page: writes of slots
with no page mapped land there and gathers of unmapped logical pages read
from there, always masked because the logical ``pos_ids`` entry is -1.

Allocator invariants, as in the reference, per shard: ``ref[s, p]``
equals the number of the shard's block-table entries mapping ``p``;
``top[s]`` + #uniquely-mapped pages == ``num_pages``; a page returns to
its shard's stack exactly at decref-to-zero.

Every allocator function is a pure function of fixed-shape device tensors
and returns a new allocator dict, like the reference, except the one the
fused decode step runs: ``alloc_decode_pages`` writes ``tbl``, ``top``
and ``ref`` in place, since the step's CUDA graph reads the allocator at
fixed addresses (``serving/graphs.py``). None syncs with the host (no
``.item()``, no boolean-mask indexing), so they run inside the fused
decode loop. PyTorch has no ``mode="drop"`` scatter: each dropped
index of the reference (the one past the end) goes to a scratch element
that is cut off (``_drop_set``), or to the trash page for pool rows.

Writes to the cache tree itself go in place: ``paginate_cache`` replaces
each layer's contiguous k/v with zero pools, and ``insert_prefill_paged``,
``begin_chunked_prefill``, ``map_shared_prefix``, ``cow_chunk_pages``,
``freeze_inactive_cursors``, ``scatter_slot_view``, ``scrub_pool``,
``migrate_pages`` and ``migrate_slot`` write the pools and the per-slot
rows of the tree they are given (and return it). Only the allocator dict
at ``caches["paged"]`` is replaced by a new one.

The fleet's shard loss and live migration (``serving/sharded.py``) add
four pool programs: ``quarantine_table`` clears a dead shard's table so
its rows write only to the trash page, ``scrub_pool`` resets a rejoining
shard, and ``export_slot`` / ``migrate_pages`` are the two halves of a
slot's move between two shards' halves of the pool, which
``migrate_slot`` composes with the source's release.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models.attention import copy_page_rows
from repro_torch.serving import sampling

_I32 = torch.int32


def _drop_set(dst: torch.Tensor, idx: torch.Tensor, val,
              accumulate: bool = False) -> torch.Tensor:
    """``dst[idx] = val`` (or ``+=`` with ``accumulate``) where an index
    equal to ``len(dst)`` is dropped, as the reference's ``mode="drop"``
    drops its one out-of-range index. Returns a new tensor."""
    row = tuple(dst.shape[1:])
    ext = torch.cat([dst, dst.new_zeros((1,) + row)])
    idx = idx.reshape(-1).long()
    if not torch.is_tensor(val):
        val = torch.full(idx.shape + row, val, dtype=dst.dtype,
                         device=dst.device)
    ext.index_put_((idx,), val.reshape(idx.shape + row).to(dst.dtype),
                   accumulate=accumulate)
    return ext[:-1]


# --------------------------------------------------------------- allocator
#
# Every allocator function takes the allocator with its leading SHARD axis
# (tbl (S, B, M), free (S, P), top (S,), ref (S, P); a single engine's is
# S = 1) and runs all shards at once, each against its own free stack. An
# argument with one entry per slot or per lane is read as (S, -1): a
# single engine passes its (B,) or (n,) vectors as they are. On the fleet,
# a lane with nothing to do is the sentinel slot B (one past the shard's
# slots), whose table writes land in a scratch row that is cut off, and a
# page id P is a dropped index (``_put_pages``).


def _cumrank(x: torch.Tensor) -> torch.Tensor:
    """0-based pop order of the True entries of each shard's ``x[s]``
    (flattened), shape (S, -1)."""
    return torch.cumsum(x.reshape(x.shape[0], -1).to(_I32), 1,
                        dtype=_I32) - 1


def _count(x: torch.Tensor) -> torch.Tensor:
    """(S,) count of the True entries of each shard's ``x[s]``."""
    return x.reshape(x.shape[0], -1).to(_I32).sum(1).to(_I32)


def _put_pages(dst: torch.Tensor, idx: torch.Tensor, val,
               accumulate: bool = False) -> torch.Tensor:
    """Per shard, ``dst[s, idx[s]] = val`` (``+=`` with ``accumulate``)
    for dst (S, P); an index P is dropped. Returns a new tensor."""
    S = dst.shape[0]
    ext = torch.cat([dst, dst.new_zeros((S, 1))], dim=1)
    idx = idx.reshape(S, -1).long()
    if not torch.is_tensor(val):
        val = torch.full(idx.shape, val, dtype=dst.dtype, device=dst.device)
    val = val.reshape(idx.shape).to(dst.dtype)
    if accumulate:
        ext.scatter_add_(1, idx, val)
    else:
        ext.scatter_(1, idx, val)
    return ext[:, :-1]


def _put_rows(tbl: torch.Tensor, slots: torch.Tensor, fn) -> torch.Tensor:
    """Per shard, rewrite the table rows ``slots[s]`` (S, n) as
    ``fn(rows)`` of the current rows (S, n, M); a sentinel slot B reads a
    row of -1 and writes into a scratch row that is cut off. Returns a new
    table."""
    S, B, M = tbl.shape
    ext = torch.cat([tbl, tbl.new_full((S, 1, M), -1)], dim=1)
    idx = (torch.arange(S, device=tbl.device)[:, None], slots.long())
    ext[idx] = fn(ext[idx])
    return ext[:, :B]


def init_allocator(max_batch: int, max_pages_per_slot: int, num_pages: int,
                   device, shards: int = 1) -> Dict[str, torch.Tensor]:
    """A fresh allocator of ``shards`` shards (a single engine's: 1)."""
    S = shards
    return {
        "tbl": torch.full((S, max_batch, max_pages_per_slot), -1,
                          dtype=_I32, device=device),
        "free": torch.arange(num_pages, dtype=_I32, device=device)
        .repeat(S, 1),
        "top": torch.full((S,), num_pages, dtype=_I32, device=device),
        "ref": torch.zeros((S, num_pages), dtype=_I32, device=device),
    }


def _set_ref(ref: torch.Tensor, pages: torch.Tensor,
             ok: torch.Tensor) -> torch.Tensor:
    """Mark freshly popped pages as singly referenced."""
    P = ref.shape[1]
    return _put_pages(ref, torch.where(ok, pages, P), 1)


def _pop(free: torch.Tensor, top: torch.Tensor, need: torch.Tensor):
    """Per shard, LIFO pops for the True entries of ``need`` (S, ...) from
    free (S, P) / top (S,): (page ids, ok) of ``need``'s shape, ``ok``
    False where the shard's stack would underflow."""
    S, P = free.shape
    take = top[:, None] - 1 - _cumrank(need)
    pages = torch.gather(free, 1, take.clamp(0, P - 1).long())
    return pages.reshape(need.shape), need & (take >= 0).reshape(need.shape)


def alloc_decode_pages(alloc: Dict, lengths: torch.Tensor,
                       active: torch.Tensor, page_size: int) -> Dict:
    """Pop one page for every ACTIVE slot whose next token starts a new
    logical page. lengths: tokens already cached; active: bool; one entry
    a slot, (S*B,) or (S, B). In place: ``tbl``, ``top`` and ``ref`` are
    written where they lie, and ``alloc`` is returned."""
    tbl, free, top = alloc["tbl"], alloc["free"], alloc["top"]
    S, B, M = tbl.shape
    lengths, active = lengths.reshape(S, B), active.reshape(S, B)
    lp = torch.div(lengths, page_size, rounding_mode="floor")
    need = active & (torch.remainder(lengths, page_size) == 0) & (lp < M)
    pages, ok = _pop(free, top, need)
    sidx = torch.arange(S, device=tbl.device)[:, None]
    bidx = torch.arange(B, device=tbl.device)[None, :]
    lp_c = lp.clamp(0, M - 1).long()
    tbl[sidx, bidx, lp_c] = torch.where(ok, pages, tbl[sidx, bidx, lp_c])
    top.sub_(_count(ok))
    alloc["ref"].copy_(_set_ref(alloc["ref"], pages, ok))
    return alloc


def alloc_prefill_pages(alloc: Dict, slots: torch.Tensor,
                        n_pages: torch.Tensor) -> Dict:
    """Bulk-pop ``n_pages[i]`` pages for slot ``slots[i]`` and rewrite the
    slot's whole block-table row (stale entries become -1)."""
    tbl, free, top = alloc["tbl"], alloc["free"], alloc["top"]
    S, _, M = tbl.shape
    slots, n_pages = slots.reshape(S, -1), n_pages.reshape(S, -1)
    need = (torch.arange(M, device=tbl.device)
            < n_pages[..., None])                      # (S, n, M)
    pages, ok = _pop(free, top, need)
    tbl = _put_rows(tbl, slots, lambda rows: torch.where(
        ok, pages, torch.full_like(pages, -1)))
    return {"tbl": tbl, "free": free, "top": top - _count(ok),
            "ref": _set_ref(alloc["ref"], pages, ok)}


def alloc_chunk_pages(alloc: Dict, slots: torch.Tensor,
                      start_pg: torch.Tensor, end_pg: torch.Tensor) -> Dict:
    """Pop pages for the logical page range [start_pg[i], end_pg[i]) of
    slot ``slots[i]``, keeping the slot's other entries. On the fleet all
    three are (S, n); a sentinel lane has an empty range."""
    tbl, free, top = alloc["tbl"], alloc["free"], alloc["top"]
    S, _, M = tbl.shape
    slots, start_pg, end_pg = (x.reshape(S, -1)
                               for x in (slots, start_pg, end_pg))
    ar = torch.arange(M, device=tbl.device)
    need = (ar >= start_pg[..., None]) & (ar < end_pg[..., None])
    pages, ok = _pop(free, top, need)                  # (S, n, M)
    tbl = _put_rows(tbl, slots, lambda rows: torch.where(ok, pages, rows))
    return {"tbl": tbl, "free": free, "top": top - _count(ok),
            "ref": _set_ref(alloc["ref"], pages, ok)}


def map_shared_pages(alloc: Dict, slot: torch.Tensor,
                     pages: torch.Tensor) -> Dict:
    """Map a resident page run (``pages``: max_pages entries a shard, -1
    padded) into logical pages 0.. of ``slot``'s table row (one slot a
    shard), increfing each page. On the fleet, a shard with nothing to map
    passes the sentinel slot and a row of -1."""
    tbl, ref = alloc["tbl"], alloc["ref"]
    S, P = ref.shape
    slot, pages = slot.reshape(S, 1), pages.reshape(S, -1)
    m = pages >= 0
    tbl = _put_rows(tbl, slot, lambda rows: torch.where(
        m[:, None], pages[:, None], rows))
    ref = _put_pages(ref, torch.where(m, pages, P), 1, accumulate=True)
    return {"tbl": tbl, "free": alloc["free"], "top": alloc["top"],
            "ref": ref}


def _return_pages(free: torch.Tensor, top: torch.Tensor, ref: torch.Tensor,
                  drops: torch.Tensor):
    """Per shard, apply per-page decref counts ``drops`` (S, P); pages
    reaching zero go back on the shard's stack in page order. Returns
    (free, top, ref)."""
    S, P = ref.shape
    ref = ref - drops
    freed = (drops > 0) & (ref <= 0)
    dest = torch.where(freed, top[:, None] + _cumrank(freed), P)
    ids = torch.arange(P, dtype=_I32, device=free.device).expand(S, P)
    free = _put_pages(free, dest, ids)
    return free, top + _count(freed), ref.clamp(min=0)


def _decrefs(pages: torch.Tensor, P: int) -> torch.Tensor:
    """Per shard, the count of each page among ``pages[s]`` (P =
    dropped): (S, P)."""
    S = pages.shape[0]
    return _put_pages(torch.zeros((S, P), dtype=_I32, device=pages.device),
                      pages, 1, accumulate=True)


def _release(a: Dict, released: torch.Tensor, rel: torch.Tensor) -> Dict:
    """Decref the table entries marked in ``rel`` (S, B, M), clear the
    ``released`` (S, B) slots' rows; pages reaching refcount zero go back
    on their shard's free stack."""
    tbl = a["tbl"]
    P = a["free"].shape[1]
    drops = _decrefs(torch.where(rel, tbl, P), P)
    free, top, ref = _return_pages(a["free"], a["top"], a["ref"], drops)
    tbl = torch.where(released[..., None], torch.full_like(tbl, -1), tbl)
    return {"tbl": tbl, "free": free, "top": top, "ref": ref}


def release_slots(alloc: Dict, released: torch.Tensor) -> Dict:
    """Decref every page mapped by the ``released`` bool slots (one entry
    a slot) and clear their table rows; pages reaching refcount zero go
    back on the free stack (shared prefix pages survive until their last
    holder)."""
    released = released.reshape(alloc["tbl"].shape[:2])
    return _release(alloc, released,
                    released[..., None] & (alloc["tbl"] >= 0))


def release_slots_keep(alloc: Dict, released: torch.Tensor,
                       n_keep: torch.Tensor) -> Dict:
    """Release the ``released`` bool slots but KEEP the references of
    each slot's first ``n_keep[slot]`` logical pages — the release for
    preemption. The kept pages' references are transferred to the engine's
    host-side pin (the evicted request's indexed prefix must stay resident
    and adoptable for its resume), so they are neither decrefed nor freed
    here; every later logical page decrefs normally. The whole table row
    is cleared either way. ``n_keep``: int32, 0 for slots not being
    preempted or with nothing indexed. Both have one entry a slot."""
    tbl = alloc["tbl"]
    released = released.reshape(tbl.shape[:2])
    n_keep = n_keep.reshape(tbl.shape[:2])
    logical = torch.arange(tbl.shape[2], dtype=_I32, device=tbl.device)
    return _release(alloc, released, released[..., None] & (tbl >= 0)
                    & (logical >= n_keep[..., None]))


def decref_pages(alloc: Dict, pages: torch.Tensor) -> Dict:
    """Drop one reference from each physical page in ``pages`` (int32, -1
    padded, the same number a shard); pages reaching refcount zero return
    to the stack. This releases a preemption pin: the resumed request
    adopts the pinned run first (``map_shared_pages`` increfs), then the
    pin's transferred references drop here — or drop without adoption when
    the preempted request is cancelled or shed."""
    S, P = alloc["free"].shape
    pages = pages.reshape(S, -1)
    drops = _decrefs(torch.where(pages >= 0, pages, P), P)
    free, top, ref = _return_pages(alloc["free"], alloc["top"],
                                   alloc["ref"], drops)
    return {"tbl": alloc["tbl"], "free": free, "top": top, "ref": ref}


def quarantine_table(alloc: Dict, do: torch.Tensor) -> Dict:
    """Route-invalidate the DEAD shards flagged in ``do`` (S,) bool: clear
    their whole block tables to -1, so the writes of their slot rows that
    keep riding every fleet forward land in the trash page, exactly like a
    released slot's, instead of in real pages of their pool.

    Deliberately NOT a release: ``ref``, ``free``, ``top`` and every KV
    payload page stay bit-identical. The dead pool is unreachable, never
    mutated; ``scrub_pool`` rebuilds it from nothing at rejoin."""
    tbl = alloc["tbl"]
    return dict(alloc, tbl=torch.where(do.reshape(-1, 1, 1),
                                       torch.full_like(tbl, -1), tbl))


def scrub_pool(pool: Dict, do: torch.Tensor) -> Dict:
    """Reset the shards flagged in ``do`` (S,) bool to the ``init_allocator``
    state (table -1, free = arange(P), top = P, ref = 0) and clear their B
    per-slot cursor rows in every layer (``pos_ids`` -1, ``length`` and
    ``t`` 0; a recurrent layer's slot state 0), in place: the REJOIN
    primitive, since a dead shard's contents are untrusted. KV payload
    pages are not zeroed: positions are logical, so stale rows are
    unreachable behind ``pos_ids == -1``, as after a release. Every other
    shard's allocator rows and cursor rows stay bit-identical, and no page
    of the pool is written."""
    a = pool["paged"]
    S, B, M = a["tbl"].shape
    fresh = init_allocator(B, M, a["free"].shape[1], do.device, shards=S)
    pool["paged"] = {k: torch.where(do.reshape((S,) + (1,) * (v.dim() - 1)),
                                    fresh[k], v) for k, v in a.items()}
    rows = do[:, None].expand(S, B).reshape(-1)          # (S*B,)

    def fill(leaf, value):
        leaf.masked_fill_(rows.reshape((-1,) + (1,) * (leaf.dim() - 1)),
                          value)

    for layer in pool["layers"]:
        for name, leaf in layer.items():
            if name not in ("k_pages", "v_pages"):
                fill(leaf, -1 if name == "pos_ids" else 0)
    fill(pool["t"], 0)
    return pool


def export_slot(pool: Dict, row: torch.Tensor, src_pg: torch.Tensor) -> Dict:
    """The SEND half of a page migration between two shards' halves of the
    pool: copies of one slot's KV pages and per-slot rows. ``row``: (1,)
    the slot's flat per-slot row s*B + b; ``src_pg``: its pages' POOL ids
    s*P + p in logical order (-1 reads the trash page, whose rows are
    never read back). Every paged layer gives ``k_rows``/``v_rows`` (Hkv,
    n, ps, hd) and the slot's ``pos_ids``/``length``; every other leaf its
    row. The payload mirrors the cache tree, so ``migrate_pages`` walks
    both in step."""
    rl = row.long()
    layers = []
    for layer in pool["layers"]:
        if "k_pages" not in layer:
            layers.append({k: v.index_select(0, rl) for k, v in layer.items()})
            continue
        trash = layer["k_pages"].shape[1] - 1
        pg = torch.where(src_pg < 0, torch.full_like(src_pg, trash),
                         src_pg).long()
        layers.append({"k_rows": layer["k_pages"].index_select(1, pg),
                       "v_rows": layer["v_pages"].index_select(1, pg),
                       "pos_ids": layer["pos_ids"].index_select(0, rl),
                       "length": layer["length"].index_select(0, rl)})
    return {"t": pool["t"].index_select(0, rl), "layers": layers}


def migrate_pages(pool: Dict, shard: int, slot: int, payload: Dict,
                  n_pages: int) -> Dict:
    """The RECEIVE half: pop ``n_pages`` pages off shard ``shard``'s free
    stack and rewrite ``slot``'s whole table row to them
    (``alloc_prefill_pages``, every other shard's lane the sentinel),
    scatter the payload's KV rows into those pages (pool ids shard*P + p)
    and restore the slot's per-slot rows, in place: the landed slot equals
    the source slot, on private pages (ref 1). Re-indexing shared-prefix
    runs in the destination is host policy."""
    a = pool["paged"]
    S, B, _ = a["tbl"].shape
    P = a["free"].shape[1]
    dev = a["tbl"].device
    lane = torch.arange(S, device=dev) == shard
    pool["paged"] = alloc_prefill_pages(
        a, torch.where(lane, slot, B).to(_I32),
        torch.where(lane, n_pages, 0).to(_I32))
    row = pool["paged"]["tbl"][shard, slot]
    rd = torch.full((1,), shard * B + slot, dtype=torch.long, device=dev)
    for layer, pl in zip(pool["layers"], payload["layers"]):
        if "k_pages" not in layer:
            for k, v in layer.items():
                v.index_copy_(0, rd, pl[k])
            continue
        n = pl["k_rows"].shape[1]
        trash = layer["k_pages"].shape[1] - 1
        dst = torch.where(row[:n] >= 0, row[:n] + shard * P,
                          torch.full_like(row[:n], trash)).long()
        layer["k_pages"].index_copy_(1, dst, pl["k_rows"])
        layer["v_pages"].index_copy_(1, dst, pl["v_rows"])
        layer["pos_ids"].index_copy_(0, rd, pl["pos_ids"])
        layer["length"].index_copy_(0, rd, pl["length"])
    pool["t"].index_copy_(0, rd, payload["t"])
    return pool


def migrate_slot(pool: Dict, cur_tokens: torch.Tensor,
                 state: Dict[str, torch.Tensor], src: tuple, dst: tuple,
                 src_pg: torch.Tensor) -> torch.Tensor:
    """Move one slot between two shards of the fleet's pool, in place: the
    one-card counterpart of the reference's cross-device migration
    program. ``src`` = (s, b) and ``dst`` = (d, slot_d); ``src_pg`` holds
    the source slot's n mapped SHARD-LOCAL pages in logical order. Copies
    the pages (``export_slot``), releases the source row sharing-aware (a
    page the slot shares survives under its other holders' references)
    and disarms it, lands the pages on n fresh pages of shard d
    (``migrate_pages``) and carries the slot's decode rows (current token,
    ``active``, ``budget``, ``eos``). Returns the destination's new table
    row (M,) of shard-local page ids."""
    (s, b), (d, bd) = src, dst
    a = pool["paged"]
    S, B, _ = a["tbl"].shape
    P = a["free"].shape[1]
    dev = a["tbl"].device
    rs = torch.full((1,), s * B + b, dtype=torch.long, device=dev)
    rd = torch.full((1,), d * B + bd, dtype=torch.long, device=dev)
    payload = export_slot(pool, rs, torch.where(src_pg >= 0, src_pg + s * P,
                                                src_pg))
    carry = {k: v.index_select(0, rs) for k, v in state.items()}
    cur = cur_tokens.index_select(0, rs)
    released = ((torch.arange(S, device=dev) == s)[:, None]
                & (torch.arange(B, device=dev) == b)[None, :])
    pool["paged"] = release_slots(a, released)
    sampling.disarm_slots(state, rs)
    migrate_pages(pool, d, bd, payload, int(src_pg.shape[0]))
    cur_tokens.index_copy_(0, rd, cur)
    for k, v in state.items():
        v.index_copy_(0, rd, carry[k])
    return pool["paged"]["tbl"][d, bd]


def _page_base(alloc: Dict) -> torch.Tensor:
    """(S, 1, 1) pool page id of each shard's page 0: s*P."""
    tbl = alloc["tbl"]
    S, P = alloc["free"].shape
    return (torch.arange(S, dtype=_I32, device=tbl.device) * P)[:, None,
                                                                 None]


def model_table(alloc: Dict, active: Optional[torch.Tensor] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (S*B, M) block table the model reads. The pools hold the S
    shards' pages side by side, ``(Hkv, S*P + 1, ps, hd)``, shard s at
    pages [s*P, (s+1)*P), and one trash page last: the shard-local ids
    become pool ids ``s*P + p``, so one kernel launch serves every
    shard's rows, and -1 stays -1 (the kernels and writes send it to the
    trash page; every such row is masked). A single engine's table (S = 1)
    is its own. With ``active``, the rows of the other slots are cleared:
    the fused step passes ``in_place_rows``, so only a slot parked with
    its next row already holding history (an adopter of a whole shared
    prompt, waiting for its copy-on-write chunk: that row lies in a page
    the prefix index serves) has its batch-shape-invariant decode write
    land in the trash page; its attention output is discarded. ``out``,
    if given, is an (S*B, M) int32 buffer that receives the table and is
    returned."""
    tbl = alloc["tbl"]
    S, B, M = tbl.shape
    keep = tbl >= 0
    if active is not None:
        keep = keep & active.reshape(S, B, 1)
    if out is None:
        out = torch.empty((S * B, M), dtype=_I32, device=tbl.device)
    torch.where(keep, tbl + _page_base(alloc), torch.full_like(tbl, -1),
                out=out.view(S, B, M))
    return out


def in_place_rows(caches: Dict, active: torch.Tensor) -> torch.Tensor:
    """(rows,) bool: the slots whose decode write may land in their own
    pages, as the reference's does: the active ones, and a parked one
    whose next row holds no history yet (its logical position there is
    -1: its next chunk writes that row again). A parked slot whose next
    row is already history, a whole-prompt adopter's last shared token,
    is not: writing it would change a page that other slots and the
    prefix index read (the reference's sharing fault). Keeping the rest
    in place keeps the trash page what the reference's holds, which a
    ``moe`` model's pad rows average."""
    layer = next(c for c in caches["layers"] if "k_pages" in c)
    pos, t = layer["pos_ids"], layer["length"]
    W = pos.shape[1]
    nxt = pos.gather(1, t.clamp(0, W - 1).long()[:, None])[:, 0]
    return active | (t >= W) | (nxt < 0)


def pages_needed(n_tokens: int, page_size: int) -> int:
    return -(-max(n_tokens, 0) // page_size)


# ----------------------------------------------------------- cache layout


def paginate_cache(cache: Dict, max_batch: int, page_size: int,
                   num_pages: int, shards: int = 1) -> Dict:
    """Turn a contiguous slot-pool cache (``Model.init_cache``) into the
    paged layout, in place, and attach the shared allocator at
    ``cache["paged"]``. Only attention layers (``k``/``v`` leaves) are
    paged; a recurrent layer's fixed-size state (mamba2 ``conv``,
    ``state``, ``length``) stays slot-addressed. ``shards`` = S makes the
    fleet's tree from a cache of S * ``max_batch`` slots: its per-slot
    rows stay flat, shard s at rows [s*B, (s+1)*B); each pool holds the S
    shards' pages side by side and one trash page, (Hkv, S*P + 1, ps, hd)
    (``model_table``); and the allocator has S shards."""
    widths = {layer["k"].shape[1] for layer in cache["layers"]
              if "k" in layer}
    if len(widths) != 1:
        raise ValueError("the paged pool needs one cache width")
    W = widths.pop()
    if W % page_size:
        raise ValueError("cache width must be a page multiple")
    for i, layer in enumerate(cache["layers"]):
        if "k" not in layer:
            continue
        k, v = layer["k"], layer["v"]
        H = k.shape[2]
        cache["layers"][i] = {
            "k_pages": torch.zeros((H, shards * num_pages + 1, page_size,
                                    k.shape[3]), dtype=k.dtype,
                                   device=k.device),
            "v_pages": torch.zeros((H, shards * num_pages + 1, page_size,
                                    v.shape[3]), dtype=v.dtype,
                                   device=v.device),
            "pos_ids": layer["pos_ids"],          # stays LOGICAL: (B, W)
            "length": layer["length"],
        }
    cache["paged"] = init_allocator(max_batch, W // page_size, num_pages,
                                    cache["t"].device, shards=shards)
    return cache


# --------------------------------------------------------------- insertion


def insert_prefill_paged(pool: Dict, src: Dict, slots: torch.Tensor,
                         cur_tokens: torch.Tensor, first_tokens: torch.Tensor,
                         state: Dict, budgets: torch.Tensor,
                         eos_ids: torch.Tensor, page_size: int) -> None:
    """Paged counterpart of ``sampling.insert_prefill``: bulk-allocate
    ceil(len/page_size) pages per admitted request, scatter the contiguous
    prefill cache rows into the pages (one indexed copy per leaf for the
    whole admission batch), copy the per-slot rows and arm the slots.
    Logical pages past a request's length scatter into the trash page. A
    recurrent layer's leaves are copied by slot, as on the contiguous
    path."""
    n = slots.shape[0]
    sl = slots.long()
    true_len = src["t"][:n]
    n_pages = torch.div(true_len + page_size - 1, page_size,
                        rounding_mode="floor")
    pool["paged"] = alloc_prefill_pages(pool["paged"], slots, n_pages)
    row_tbl = model_table(pool["paged"])[sl]             # (n, M)
    M = row_tbl.shape[1]
    for dst, s in zip(pool["layers"], src["layers"]):
        if "k_pages" not in dst:
            for name, leaf in dst.items():
                leaf[sl] = s[name][:n]
            continue
        for name, leaf in (("k_pages", "k"), ("v_pages", "v")):
            pages = dst[name]                            # (H, P+1, ps, hd)
            trash = pages.shape[1] - 1
            pg = torch.where(row_tbl < 0, torch.full_like(row_tbl, trash),
                             row_tbl).long()
            sv = s[leaf][:n].permute(2, 0, 1, 3)         # (H, n, W, hd)
            pages[:, pg] = sv.reshape(sv.shape[0], n, M, page_size,
                                      sv.shape[-1]).to(pages.dtype)
        dst["pos_ids"][sl] = s["pos_ids"][:n]
        dst["length"][sl] = s["length"][:n]
    pool["t"][sl] = src["t"][:n]
    sampling.arm_slots(cur_tokens, state, slots, first_tokens, budgets,
                       eos_ids)


# ----------------------------------------------------- chunked prefill view


def begin_chunked_prefill(pool: Dict, slots: torch.Tensor) -> Dict:
    """Reset the admitted slots' per-slot rows for a fresh chunked prefill:
    logical positions all empty, lengths and counters zero. Pool pages and
    table rows are untouched — a released tenant already cleared its row,
    and its stale pool rows are unreachable behind ``pos_ids == -1``."""
    sl = slots.long()
    # index_fill_, not ``x[sl] = -1``: a Python scalar assigned through a
    # tensor index is copied from the host and waits for the stream
    for layer in pool["layers"]:
        layer["pos_ids"].index_fill_(0, sl, -1)
        layer["length"].index_fill_(0, sl, 0)
    pool["t"].index_fill_(0, sl, 0)
    return pool


def _slot_rows(alloc: Dict, slots: torch.Tensor) -> torch.Tensor:
    """Flat per-slot tree rows of the allocator lanes ``slots`` (read as
    (S, n)): shard s's slot b at row s*B + b, a fleet's sentinel lane at
    S*B, past the rows."""
    S, B = alloc["tbl"].shape[:2]
    slots = slots.reshape(S, -1)
    base = torch.arange(S, dtype=slots.dtype, device=slots.device)[:, None]
    return torch.where(slots < B, slots + base * B,
                       torch.full_like(slots, S * B)).reshape(-1)


def map_shared_prefix(pool: Dict, slot: torch.Tensor, pages: torch.Tensor,
                      n_shared: torch.Tensor, start_tok: torch.Tensor) -> Dict:
    """Adopt a resident prefix into a freshly admitted slot: incref the
    run into its table row, mark logical rows [0, n_shared) as valid
    history, and set the write cursors to ``start_tok``, the first token
    the slot will compute (< n_shared only when the whole prompt is
    shared: the last prompt token is recomputed for first-token logits,
    into a shared page that ``cow_chunk_pages`` privatizes first). Every
    argument has one entry a shard, as in ``map_shared_pages``; a fleet's
    sentinel lane writes nothing."""
    rows = _slot_rows(pool["paged"], slot)
    pool["paged"] = map_shared_pages(pool["paged"], slot, pages)
    n_shared, start_tok = n_shared.reshape(-1), start_tok.reshape(-1)
    for layer in pool["layers"]:
        W = layer["pos_ids"].shape[-1]
        ar = torch.arange(W, dtype=_I32, device=pages.device)
        layer["pos_ids"].copy_(_drop_set(
            layer["pos_ids"], rows,
            torch.where(ar < n_shared[:, None], ar, torch.full_like(ar, -1))))
        layer["length"].copy_(_drop_set(layer["length"], rows, start_tok))
    pool["t"].copy_(_drop_set(pool["t"], rows, start_tok))
    return pool


def cow_chunk_pages(pool: Dict, slots: torch.Tensor, start_tok: torch.Tensor,
                    n_tok: torch.Tensor, page_size: int, span: int) -> Dict:
    """Copy-on-write for the logical pages the next chunk write touches.

    slots/start_tok/n_tok: int32 lanes, read as (S, n) (a fleet's
    sentinel lane has ``n_tok`` 0) — the chunk writes tokens [start_tok, start_tok
    + n_tok) of each slot; ``span`` bounds the pages one chunk can touch.
    A touched page mapped with refcount > 1 is privatized before the
    write: pop a fresh page from its shard's stack, copy its rows in every
    layer's pools, swap the table entry, decref the original (returning
    it to the stack if that was its last reference)."""
    a = pool["paged"]
    tbl, free, top, ref = a["tbl"], a["free"], a["top"], a["ref"]
    S, B, M = tbl.shape
    P = free.shape[1]
    slots, start_tok, n_tok = (x.reshape(S, -1)
                               for x in (slots, start_tok, n_tok))
    dev = tbl.device
    lp = (torch.div(start_tok, page_size, rounding_mode="floor")[..., None]
          + torch.arange(span, dtype=_I32, device=dev))   # (S, n, span)
    last = torch.div(start_tok + n_tok.clamp(min=1) - 1, page_size,
                     rounding_mode="floor")
    valid = (n_tok[..., None] > 0) & (lp <= last[..., None]) & (lp < M)
    # the table with a scratch row (sentinel slot B) and column (entries
    # that touch nothing), cut off after the swap
    ext = torch.full((S, B + 1, M + 1), -1, dtype=_I32, device=dev)
    ext[:, :B, :M] = tbl
    sidx = torch.arange(S, device=dev)[:, None, None].expand(lp.shape)
    sl = slots.long()[..., None].expand(lp.shape)
    col = torch.where(valid, lp, torch.full_like(lp, M)).long()
    phys = ext[sidx, sl, col]                            # (S, n, span)
    held = torch.gather(ref, 1, phys.clamp(0, P - 1).reshape(S, -1).long())
    do = valid & (phys >= 0) & (held.reshape(phys.shape) > 1)
    fresh, ok = _pop(free, top, do)
    ext[sidx, sl, col] = torch.where(ok, fresh, phys)
    tbl = ext[:, :B, :M].contiguous()
    dec = _decrefs(torch.where(ok, phys, P), P)
    new_top = top - _count(ok)
    free, new_top, ref = _return_pages(free, new_top, ref, dec)
    ref = _set_ref(ref, fresh, ok)
    pool["paged"] = {"tbl": tbl, "free": free, "top": new_top, "ref": ref}
    # pool page ids: shard s's page p is page s*P + p of each pool
    base = _page_base(a)
    src_pg = torch.where(ok, phys + base, 0).reshape(-1)
    dst_pg = torch.where(ok, fresh + base, -1).reshape(-1)  # -1 = dropped
    for layer in pool["layers"]:
        copy_page_rows(layer["k_pages"], src_pg, dst_pg)
        copy_page_rows(layer["v_pages"], src_pg, dst_pg)
    return pool


def snapshot_cursors(pool: Dict, out: Optional[Dict] = None) -> Dict:
    """Copies of the per-slot write cursors (``t``, each layer's
    ``pos_ids`` and ``length``), for ``freeze_inactive_cursors``. ``out``,
    an earlier snapshot of the same tree, is filled in place and
    returned."""
    if out is None:
        return {"t": pool["t"].clone(),
                "layers": [{"pos_ids": layer["pos_ids"].clone(),
                            "length": layer["length"].clone()}
                           for layer in pool["layers"]]}
    out["t"].copy_(pool["t"])
    for o, layer in zip(out["layers"], pool["layers"]):
        o["pos_ids"].copy_(layer["pos_ids"])
        o["length"].copy_(layer["length"])
    return out


def freeze_inactive_cursors(old: Dict, pool: Dict,
                            active: torch.Tensor) -> Dict:
    """Put INACTIVE slots' write cursors back to their pre-step values
    (``old``, from ``snapshot_cursors``) after a fused decode micro-step,
    in place. A slot parked mid-chunked-prefill keeps its logical position
    exact while decode runs around it."""
    for o, layer in zip(old["layers"], pool["layers"]):
        layer["pos_ids"].copy_(torch.where(active[:, None], layer["pos_ids"],
                                           o["pos_ids"]))
        layer["length"].copy_(torch.where(active, layer["length"],
                                          o["length"]))
    pool["t"].copy_(torch.where(active, pool["t"], old["t"]))
    return pool


def gather_slot_view(pool: Dict, slots: torch.Tensor) -> Dict:
    """Batch-n view of the paged cache tree for a chunked-prefill step:
    the per-slot rows (``pos_ids``, ``length``, ``t``) gathered to
    ``slots`` (copies), the shared page pools riding through whole (the
    same tensors: the chunk writes them in place), and the allocator
    reduced to the slots' table rows."""
    sl = slots.long()
    return {
        "t": pool["t"][sl],
        "layers": [{"k_pages": layer["k_pages"], "v_pages": layer["v_pages"],
                    "pos_ids": layer["pos_ids"][sl],
                    "length": layer["length"][sl]}
                   for layer in pool["layers"]],
        "paged": {"tbl": model_table(pool["paged"])[sl]},
    }


def slot_view_rows(view: Dict, rows: torch.Tensor) -> Dict:
    """The per-slot rows ``rows`` of a ``gather_slot_view`` tree (its
    pools and table rows as they are): what ``scatter_slot_view`` writes
    back."""
    return {"t": view["t"][rows],
            "layers": [{**layer, "pos_ids": layer["pos_ids"][rows],
                        "length": layer["length"][rows]}
                       for layer in view["layers"]],
            "paged": view["paged"]}


def scatter_slot_view(pool: Dict, view: Dict, slots: torch.Tensor) -> Dict:
    """Write a chunk-updated ``gather_slot_view`` tree's per-slot rows back
    into ``slots`` of the full tree, in place."""
    sl = slots.long()
    for layer, v in zip(pool["layers"], view["layers"]):
        layer["pos_ids"][sl] = v["pos_ids"]
        layer["length"][sl] = v["length"]
    pool["t"][sl] = view["t"]
    return pool
