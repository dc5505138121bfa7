"""The port's paged KV pool against the JAX package, on the CPU.

* Kernels: the plain paged-decode and chunked-prefill functions (the CPU
  path of ``repro_torch.kernels.ops``) against the JAX ops, through the
  Pallas kernels in interpret mode and through the jnp oracles, on the
  sweeps of tests/test_paged_kernel.py and test_chunked_prefill_kernel.py.
  Only valid query rows are compared (a pad row's output is unspecified).
* Allocator: one scripted sequence of alloc, map_shared, copy-on-write,
  release and decref applied to both packages; the block table, the live
  free stack, ``top`` and the refcounts agree exactly after every step,
  and pages are conserved.
* Layout ops: the paged decode / chunk writes and the page copy on the
  same pool (the reference drops some writes that the port sends to the
  trash page, so the trash page itself is not compared).
* Model: chunk-mode and paged decode logits against the JAX ``Model`` on
  the two ported smoke configs, on the reference's own parameters.

Inputs are made with numpy from a seed. float32; atol/rtol 1e-5: the same
f32 math in another order."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as JOPS
from repro.models import Model as JModel
from repro.models import attention as JA
from repro.serving import paged as JPG
from repro_torch.configs import get_config
from repro_torch.kernels import ops as TOPS
from repro_torch.models import Model
from repro_torch.models import attention as TA
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import paged as TPG

TOL = dict(atol=1e-5, rtol=1e-5)
T = torch.from_numpy


def _pool(rng, B, Hkv, hd, ps, num_pages, lens, M, S=None, unmapped=()):
    """Random pool + block tables for slots holding ``lens`` tokens, pages
    drawn from a shuffled permutation; logical pages listed in
    ``unmapped`` ((slot, page) pairs) are left at -1 with their positions
    -1 too. With ``S``, the LAST min(S, len) tokens of each slot form the
    current chunk (q_pos, pads -1); else q_pos is the last token."""
    kp = rng.standard_normal((Hkv, num_pages + 1, ps, hd), dtype=np.float32)
    vp = rng.standard_normal((Hkv, num_pages + 1, ps, hd), dtype=np.float32)
    perm = rng.permutation(num_pages)
    tbl = np.full((B, M), -1, np.int32)
    kpos = np.full((B, M * ps), -1, np.int32)
    pi = 0
    for b, L in enumerate(lens):
        npg = -(-L // ps)
        tbl[b, :npg] = perm[pi:pi + npg]
        pi += npg
        kpos[b, :L] = np.arange(L)
    for b, lp in unmapped:
        tbl[b, lp] = -1
        kpos[b, lp * ps:(lp + 1) * ps] = -1
    if S is None:
        qpos = np.array([L - 1 for L in lens], np.int32)
    else:
        qpos = np.full((B, S), -1, np.int32)
        for b, L in enumerate(lens):
            nv = min(S, L)
            qpos[b, :nv] = np.arange(L - nv, L)
    return kp, vp, tbl, qpos, kpos


def _jnp(*xs):
    return [jnp.asarray(x) for x in xs]


# ------------------------------------------------------------------ kernels


@pytest.mark.parametrize("impl", ["pallas_interpret", "ref"])
@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_paged_decode_plain_matches_jax(impl, group, page_size):
    B, Hkv, hd, M = 3, 2, 16, 4
    lens = [13, 3 * page_size, 5]           # partial page, exact fill, tiny
    rng = np.random.default_rng(group * 17 + page_size)
    kp, vp, tbl, qpos, kpos = _pool(rng, B, Hkv, hd, page_size, B * M - 2,
                                    lens, M)
    q = rng.standard_normal((B, Hkv * group, hd), dtype=np.float32)
    want = JOPS.paged_decode_attention(*_jnp(q, kp, vp, tbl, qpos, kpos),
                                       impl=impl)
    got = TOPS.paged_decode_attention(T(q), T(kp), T(vp), T(tbl), T(qpos),
                                      T(kpos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", ["pallas_interpret", "ref"])
@pytest.mark.parametrize("case", ["window", "unmapped"])
def test_paged_decode_masking_matches_jax(impl, case):
    """Sliding-window masking through the table, and logical pages left
    unmapped in the middle of a slot (read from the trash page, masked)."""
    B, Hq, Hkv, hd, ps, M = 2, 4, 2, 16, 8, 4
    rng = np.random.default_rng(11)
    unmapped = [(0, 1)] if case == "unmapped" else []
    kp, vp, tbl, qpos, kpos = _pool(rng, B, Hkv, hd, ps, B * M, [27, 9], M,
                                    unmapped=unmapped)
    window = 9 if case == "window" else None
    q = rng.standard_normal((B, Hq, hd), dtype=np.float32)
    want = JOPS.paged_decode_attention(*_jnp(q, kp, vp, tbl, qpos, kpos),
                                       window=window, impl=impl)
    got = TOPS.paged_decode_attention(T(q), T(kp), T(vp), T(tbl), T(qpos),
                                      T(kpos), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _chunk_case(impl, group, page_size, chunk_len, window=None,
                unmapped=(), seed=0):
    B, Hkv, hd, M = 3, 2, 16, 4
    lens = [2 * page_size + 5, 3, min(chunk_len + page_size - 1,
                                      M * page_size)]
    rng = np.random.default_rng(seed)
    kp, vp, tbl, qpos, kpos = _pool(rng, B, Hkv, hd, page_size, B * M - 2,
                                    lens, M, S=chunk_len, unmapped=unmapped)
    q = rng.standard_normal((B, Hkv * group, chunk_len, hd),
                            dtype=np.float32)
    want = np.asarray(JOPS.chunked_prefill_attention(
        *_jnp(q, kp, vp, tbl, qpos, kpos), window=window, impl=impl))
    got = TOPS.chunked_prefill_attention(T(q), T(kp), T(vp), T(tbl),
                                         T(qpos), T(kpos),
                                         window=window).numpy()
    valid = qpos >= 0                        # pad query rows are don't-cares
    for b in range(B):
        np.testing.assert_allclose(got[b][:, valid[b]], want[b][:, valid[b]],
                                   **TOL)
    return q, kp, vp, tbl, qpos, kpos, got


@pytest.mark.parametrize("impl", ["pallas_interpret", "ref"])
@pytest.mark.parametrize("chunk_len", [4, 8, 16])
@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_chunked_prefill_plain_matches_jax(impl, group, page_size,
                                           chunk_len):
    """History + partial chunk, chunk == whole short prompt, and a chunk
    crossing a page boundary."""
    _chunk_case(impl, group, page_size, chunk_len,
                seed=group * 31 + page_size * 7 + chunk_len)


@pytest.mark.parametrize("impl", ["pallas_interpret", "ref"])
@pytest.mark.parametrize("case", ["window", "unmapped"])
def test_chunked_prefill_masking_matches_jax(impl, case):
    if case == "window":
        _chunk_case(impl, 2, 8, 8, window=6, seed=5)
    else:
        # slot 0's first page unmapped: its history starts at page 1
        _chunk_case(impl, 2, 8, 8, unmapped=[(0, 0)], seed=6)


def test_chunked_prefill_is_causal_inside_the_chunk():
    """Keys of the chunk's later positions never reach an earlier query:
    poisoning the pool rows of positions > p leaves query p unchanged."""
    q, kp, vp, tbl, qpos, kpos, got = _chunk_case("ref", 2, 8, 8, seed=9)
    b, ps = 0, 8
    first = int(qpos[b, 0])                  # earliest query of slot 0
    k2, v2 = kp.copy(), vp.copy()
    for pos in range(first + 1, int(kpos[b].max()) + 1):
        page, row = tbl[b, pos // ps], pos % ps
        k2[:, page, row] = 1e3
        v2[:, page, row] = -1e3
    again = TOPS.chunked_prefill_attention(T(q), T(k2), T(v2), T(tbl),
                                           T(qpos), T(kpos)).numpy()
    np.testing.assert_allclose(again[b, :, 0], got[b, :, 0], **TOL)
    assert not np.allclose(again[b, :, -1], got[b, :, -1])


# ---------------------------------------------------------------- allocator


def _jax_tree(alloc, B, M, P, ps):
    kv = jnp.zeros((1, P + 1, ps, 2), jnp.float32)
    return {"layer": {"k_pages": kv, "v_pages": kv,
                      "pos_ids": jnp.full((B, M * ps), -1, jnp.int32),
                      "length": jnp.zeros((B,), jnp.int32)},
            "t": jnp.zeros((B,), jnp.int32), "paged": alloc}


def _port_tree(alloc, B, M, P, ps):
    kv = torch.zeros((1, P + 1, ps, 2))
    return {"layers": [{"k_pages": kv, "v_pages": kv.clone(),
                        "pos_ids": torch.full((B, M * ps), -1,
                                              dtype=torch.int32),
                        "length": torch.zeros((B,), dtype=torch.int32)}],
            "t": torch.zeros((B,), dtype=torch.int32), "paged": alloc}


def test_allocator_script_matches_jax():
    B, M, P, ps = 3, 4, 10, 4
    i32 = np.int32

    def both(fn_name, *args, tree=False, pinned=0, **kw):
        """Apply one allocator step to both packages' current state;
        ``pinned`` references are held outside every table row."""
        jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
                 for a in args]
        targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                 for a in args]
        if tree:
            jt = getattr(JPG, fn_name)(_jax_tree(state["j"], B, M, P, ps),
                                       *jargs, **kw)
            tt = getattr(TPG, fn_name)(_port_tree(state["t"], B, M, P, ps),
                                       *targs, **kw)
            state["j"], state["t"] = jt["paged"], tt["paged"]
        else:
            state["j"] = getattr(JPG, fn_name)(state["j"], *jargs, **kw)
            state["t"] = getattr(TPG, fn_name)(state["t"], *targs, **kw)
        j = {k: np.asarray(v) for k, v in state["j"].items()}
        t = {k: v.numpy()[0] for k, v in state["t"].items()}   # S = 1
        top = int(j["top"])
        assert int(t["top"]) == top, fn_name
        np.testing.assert_array_equal(t["tbl"], j["tbl"], err_msg=fn_name)
        np.testing.assert_array_equal(t["ref"], j["ref"], err_msg=fn_name)
        np.testing.assert_array_equal(t["free"][:top], j["free"][:top],
                                      err_msg=fn_name)
        assert t["tbl"].dtype == np.int32 and t["top"].dtype == np.int32
        counts = np.bincount(t["tbl"][t["tbl"] >= 0], minlength=P)
        np.testing.assert_array_equal(t["ref"], counts + pinned,
                                      err_msg=fn_name)
        held = int(((counts + pinned) > 0).sum())
        assert top + held == P, fn_name                      # conservation
        assert len(set(t["free"][:top].tolist())) == top
        steps.append(fn_name)

    state = {"j": JPG.init_allocator(B, M, P),
             "t": TPG.init_allocator(B, M, P, "cpu")}
    steps = []
    both("alloc_prefill_pages", np.array([0], i32), np.array([3], i32))
    shared = np.full((M,), -1, i32)
    shared[:2] = state["t"]["tbl"][0, 0, :2].numpy()
    both("map_shared_pages", np.array(1, i32), shared)
    both("map_shared_pages", np.array(2, i32), shared)
    both("alloc_chunk_pages", np.array([1, 2], i32), np.array([2, 2], i32),
         np.array([3, 4], i32))
    # slot 1 writes token 2*ps-1 (inside shared page 1): copy-on-write
    both("cow_chunk_pages", np.array([1], i32), np.array([2 * ps - 1], i32),
         np.array([1], i32), tree=True, page_size=ps, span=2)
    both("alloc_decode_pages", np.array([12, 8, 16, 0], i32)[:B],
         np.array([True, False, True]), ps)
    both("release_slots", np.array([True, False, False]))
    # the two remaining holders of page 0 copy-on-write it in ONE call:
    # each gets a private copy and the orphaned original returns
    both("cow_chunk_pages", np.array([1, 2], i32), np.array([0, 0], i32),
         np.array([2, 2], i32), tree=True, page_size=ps, span=2)
    both("release_slots", np.array([False, True, False]))
    both("alloc_prefill_pages", np.array([0], i32), np.array([2], i32))
    pin = np.full((M,), -1, i32)
    pin[:1] = state["t"]["tbl"][0, 0, :1].numpy()
    both("map_shared_pages", np.array(1, i32), pin)
    both("release_slots", np.array([True, True, False]))
    both("release_slots", np.array([False, False, True]))
    assert steps[-1] == "release_slots" and int(state["t"]["top"]) == P
    # a pinned run: its references leave the table (as a preempted slot's
    # do) and decref_pages returns the pages exactly once
    both("alloc_prefill_pages", np.array([2], i32), np.array([2], i32))
    run = state["t"]["tbl"][0, 2].numpy().copy()
    pin_refs = np.bincount(run[run >= 0], minlength=P)
    state["j"] = dict(state["j"], tbl=state["j"]["tbl"].at[2].set(-1))
    state["t"] = dict(state["t"], tbl=state["t"]["tbl"].clone())
    state["t"]["tbl"][0, 2] = -1
    both("map_shared_pages", np.array(0, i32), run, pinned=pin_refs)
    both("decref_pages", run)
    both("release_slots", np.array([True, False, False]))
    assert int(state["t"]["top"]) == P and len(steps) == 17


# ------------------------------------------------------------- layout ops


def _leaf(rng, B, W, H, P, ps, hd):
    kp = rng.standard_normal((H, P + 1, ps, hd), dtype=np.float32)
    vp = rng.standard_normal((H, P + 1, ps, hd), dtype=np.float32)
    pos = np.full((B, W), -1, np.int32)
    length = np.zeros((B,), np.int32)
    return kp, vp, pos, length


def _both_leaves(kp, vp, pos, length):
    j = {"k_pages": jnp.asarray(kp), "v_pages": jnp.asarray(vp),
         "pos_ids": jnp.asarray(pos), "length": jnp.asarray(length)}
    t = {"k_pages": T(kp.copy()), "v_pages": T(vp.copy()),
         "pos_ids": T(pos.copy()), "length": T(length.copy())}
    return j, t


def _assert_leaves(j, t, trash):
    for name in ("pos_ids", "length"):
        np.testing.assert_array_equal(t[name].numpy(), np.asarray(j[name]))
    for name in ("k_pages", "v_pages"):
        np.testing.assert_array_equal(t[name].numpy()[:, :trash],
                                      np.asarray(j[name])[:, :trash])


def test_paged_decode_write_matches_jax():
    """Slots with a mapped page, an unmapped one (trash) and a cursor past
    the table (trash)."""
    rng = np.random.default_rng(1)
    B, H, P, ps, hd, M = 4, 2, 8, 4, 8, 3
    kp, vp, pos, length = _leaf(rng, B, M * ps, H, P, ps, hd)
    length[:] = [5, 2, 12, 8]
    tbl = np.array([[0, 3, -1], [6, -1, -1], [1, 2, 4], [5, 7, -1]], np.int32)
    j, t = _both_leaves(kp, vp, pos, length)
    k1 = rng.standard_normal((B, 1, H, hd), dtype=np.float32)
    v1 = rng.standard_normal((B, 1, H, hd), dtype=np.float32)
    j = JA.paged_decode_write(j, jnp.asarray(tbl), jnp.asarray(k1),
                              jnp.asarray(v1))
    TA.paged_decode_write(t, T(tbl), T(k1), T(v1))
    _assert_leaves(j, t, P)


def test_paged_chunk_write_matches_jax():
    """A chunk with pad tokens, one crossing into an unmapped page, and one
    whose rows run past the table."""
    rng = np.random.default_rng(2)
    B, H, P, ps, hd, M, S = 3, 2, 9, 4, 8, 3, 6
    kp, vp, pos, length = _leaf(rng, B, M * ps, H, P, ps, hd)
    tbl = np.array([[0, 3, 8], [6, -1, -1], [1, 2, 4]], np.int32)
    positions = np.array([[0, 1, 2, 3, 4, -1],       # pad tail
                          [2, 3, 4, 5, 6, 7],        # into unmapped page 1
                          [8, 9, 10, 11, 12, 13]],   # rows past the table
                         np.int32)
    j, t = _both_leaves(kp, vp, pos, length)
    k = rng.standard_normal((B, S, H, hd), dtype=np.float32)
    v = rng.standard_normal((B, S, H, hd), dtype=np.float32)
    j = JA.paged_chunk_write(j, jnp.asarray(tbl), jnp.asarray(k),
                             jnp.asarray(v), jnp.asarray(positions))
    TA.paged_chunk_write(t, T(tbl), T(k), T(v), T(positions))
    _assert_leaves(j, t, P)


def test_copy_page_rows_matches_jax():
    """Copies between pages of one pool, one of them onto a page that is
    itself a source of the same call, and a skipped (-1) destination."""
    rng = np.random.default_rng(3)
    kp = rng.standard_normal((2, 7, 4, 8), dtype=np.float32)
    src = np.array([1, 4, 2], np.int32)
    dst = np.array([4, 5, -1], np.int32)
    want = np.asarray(JA.copy_page_rows(jnp.asarray(kp), jnp.asarray(src),
                                        jnp.asarray(dst)))
    got = TA.copy_page_rows(T(kp.copy()), T(src), T(dst)).numpy()
    np.testing.assert_array_equal(got[:, :6], want[:, :6])
    np.testing.assert_array_equal(got[:, 5], kp[:, 4])   # read before write
    tbl = np.array([[4, 1], [0, 5]], np.int32)
    np.testing.assert_array_equal(
        TA.gather_pages(T(got), T(tbl)).numpy(),
        np.asarray(JA.gather_pages(jnp.asarray(want), jnp.asarray(tbl))))
    np.testing.assert_array_equal(
        TA.gather_pages_hb(T(got), T(tbl)).numpy(),
        np.asarray(JA.gather_pages_hb(jnp.asarray(want), jnp.asarray(tbl))))


def test_duplicate_rows_outside_the_trash_page_raise():
    """Two writes of one call on one real pool row are a bug (aliased
    pages); the CPU path checks it."""
    rng = np.random.default_rng(4)
    kp, vp, pos, length = _leaf(rng, 2, 8, 1, 4, 4, 8)
    _, t = _both_leaves(kp, vp, pos, length)
    tbl = torch.tensor([[2, -1], [2, -1]], dtype=torch.int32)
    with pytest.raises(AssertionError, match="trash"):
        TA.paged_decode_write(t, tbl, torch.zeros(2, 1, 1, 8),
                              torch.zeros(2, 1, 1, 8))


# ------------------------------------------------------------------- model


@pytest.mark.parametrize("arch", ["llama3.2-1b", "llama-paper-1b"])
def test_chunk_mode_logits_match_jax(arch):
    """Two slots prefill a prompt in chunks of 8 (the second chunk runs
    over the first's paged history, the last one is partial), then decode
    three tokens through the paged pool: logits agree with the JAX
    ``Model.prefill_chunk`` / ``decode_step`` on the same parameters."""
    jcfg = jax_get_config(arch, "smoke")
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(arch, "smoke")
    model = Model(cfg, "cpu")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             cfg, "cpu")
    B, max_len, ps, P, C = 3, 32, 4, 20, 8
    jc = JPG.paginate_cache(jmodel.init_cache(B, max_len), B, ps, P)
    tc = TPG.paginate_cache(model.init_cache(B, max_len), B, ps, P)
    rng = np.random.default_rng(8)
    slots = np.array([2, 0], np.int32)
    prompts = [rng.integers(2, 500, 19), rng.integers(2, 500, 11)]
    jchunk = jax.jit(jmodel.prefill_chunk)
    for c0 in range(0, 19, C):
        tokens = np.zeros((2, C), np.int32)
        mask = np.zeros((2, C), np.int32)
        for i, p in enumerate(prompts):
            piece = p[c0:c0 + C]
            tokens[i, :len(piece)] = piece
            mask[i, :len(piece)] = 1
        nv = mask.sum(1).astype(np.int32)
        t0 = np.array([min(c0, len(p)) for p in prompts], np.int32)
        start = (t0 + ps - 1) // ps
        end = (t0 + nv + ps - 1) // ps
        jc = dict(jc, paged=JPG.alloc_chunk_pages(
            jc["paged"], *_jnp(slots, start, end)))
        tc["paged"] = TPG.alloc_chunk_pages(tc["paged"], T(slots), T(start),
                                            T(end))
        jview = JPG.gather_slot_view(jc, jnp.asarray(slots))
        want, jview = jchunk(jparams, jview, jnp.asarray(tokens),
                             jnp.asarray(mask))
        jc = JPG.scatter_slot_view(jc, jview, jnp.asarray(slots))
        tview = TPG.gather_slot_view(tc, T(slots))
        got, tview = model.prefill_chunk(params, tview, T(tokens), T(mask))
        TPG.scatter_slot_view(tc, tview, T(slots))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"chunk at {c0}")
    np.testing.assert_array_equal(tc["t"].numpy(), np.asarray(jc["t"]))
    active = np.zeros((B,), bool)
    active[slots] = True
    jstep = jax.jit(jmodel.decode_step)
    for i in range(3):
        tok = rng.integers(2, 500, (B, 1)).astype(np.int32)
        jc = dict(jc, paged=JPG.alloc_decode_pages(
            jc["paged"], jc["t"], jnp.asarray(active), ps))
        tc["paged"] = TPG.alloc_decode_pages(tc["paged"], tc["t"],
                                             T(active), ps)
        want, jc = jstep(jparams, jc, jnp.asarray(tok))
        got, tc = model.decode_step(params, tc, T(tok))
        np.testing.assert_allclose(got.numpy()[slots],
                                   np.asarray(want)[slots], **TOL,
                                   err_msg=f"decode step {i}")
