"""K5, the port's histogram (dsrc_tpu_torch/ops/hist_kernels.py), against
the JAX package's histograms and a numpy count, on the CPU (where the
wrappers run their plain PyTorch versions); and the launch arguments of
its routes and of the alternatives k5_variants.py times, read through a
numpy mirror of the kernel's element rule.

The JAX functions: ops/ctx.hist_update (its matrix-unit branch up to
2^18 bins, its scatter branch beyond), parallel/uniform_pipeline._pos_hist
and ops/transform.histogram.  Counts are exact integers, so every
comparison is exact equality.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k5_variants as KV

from dsrc_tpu.ops import ctx as JC
from dsrc_tpu.ops import transform as JT
from dsrc_tpu.parallel import uniform_pipeline as JUP
from dsrc_tpu_torch.config import DsrcException
from dsrc_tpu_torch.ops import ctx as TC
from dsrc_tpu_torch.ops import hist_kernels as HK
from dsrc_tpu_torch.ops import transform as TT
from dsrc_tpu_torch.parallel import uniform_pipeline as TUP
from torch_threads import one_torch_thread  # noqa: F401


def np_count(ids, keep, nbins):
    """Counts of the kept ids in [0, nbins); others are dropped."""
    ids = np.asarray(ids, np.int64).reshape(-1)
    keep = np.asarray(keep, bool).reshape(-1) & (ids >= 0) & (ids < nbins)
    return np.bincount(ids[keep], minlength=nbins)


def port_flat(ids, keep, nbins):
    hist = torch.zeros(nbins + 1, dtype=torch.int64)
    HK.hist_count(hist, torch.from_numpy(np.ascontiguousarray(ids)),
                  None if keep is None else torch.from_numpy(keep))
    return hist[:nbins].numpy()


def _ids_cases(rng, n, nbins):
    """(name, ids int32, active bool) with masks, ids below 0 and at or
    above nbins, nothing active, and every element in one bin."""
    skew = np.minimum(rng.geometric(0.002, n) - 1, nbins - 1)
    wild = rng.integers(-nbins // 4, nbins + nbins // 4, n)
    return [("skewed", skew, rng.random(n) < 0.7),
            ("out_of_range", wild, rng.random(n) < 0.9),
            ("none_active", skew, np.zeros(n, bool)),
            ("one_bin", np.full(n, nbins // 3), np.ones(n, bool))]


@pytest.mark.parametrize("nbins", [64 * 64, 4096 * 64])
def test_hist_update_matches_jax_matrix_unit_branch(nbins):
    """nbins <= 512 x 512: JAX counts by the int8 one-hot matmul, which
    drops ids outside [0, nbins) as the port does."""
    rng = np.random.default_rng(nbins)
    for name, ids, act in _ids_cases(rng, 20_000, nbins):
        ids = ids.astype(np.int32)
        ref = np.asarray(JC.hist_update(jnp.asarray(ids), jnp.asarray(act),
                                        nbins))
        got = TC.hist_update(torch.from_numpy(ids), torch.from_numpy(act),
                             nbins)
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)
        np.testing.assert_array_equal(port_flat(ids, act, nbins), ref,
                                      err_msg=name)
        np.testing.assert_array_equal(ref, np_count(ids, act, nbins))


def test_hist_update_matches_jax_scatter_branch():
    """nbins > 2^18: JAX scatter-adds.  Its indexing wraps an id in
    [-nbins, 0) to id + nbins, as NumPy's does; no caller makes such an id
    (every bin id is ctx * A + sym >= 0), and the port drops it, as the
    matrix-unit branch does.  So JAX is given those ids inactive."""
    nbins = 4097 * 64
    rng = np.random.default_rng(5)
    for name, ids, act in _ids_cases(rng, 20_000, nbins):
        ids = ids.astype(np.int32)
        ref = np.asarray(JC.hist_update(jnp.asarray(ids),
                                        jnp.asarray(act & (ids >= 0)), nbins))
        got = TC.hist_update(torch.from_numpy(ids), torch.from_numpy(act),
                             nbins)
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)
        np.testing.assert_array_equal(port_flat(ids, act, nbins), ref,
                                      err_msg=name)
        np.testing.assert_array_equal(ref, np_count(ids, act, nbins))


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.int32])
def test_histogram_matches_jax_for_each_value_type(dtype):
    rng = np.random.default_rng(np.dtype(dtype).itemsize)
    nsym, n = 40, 30_000
    vals = np.minimum(rng.geometric(0.08, n) - 1, 60).astype(dtype)
    act = rng.random(n) < 0.8
    ref = np.asarray(JT.histogram(jnp.asarray(vals), nsym, jnp.asarray(act)))
    got = TT.histogram(torch.from_numpy(vals), nsym, torch.from_numpy(act))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    # without a mask every value in range counts
    ref = np.asarray(JT.histogram(jnp.asarray(vals), nsym,
                                  jnp.ones(n, bool)))
    np.testing.assert_array_equal(
        TT.histogram(torch.from_numpy(vals), nsym).numpy(), ref)
    if dtype != np.uint8:
        # negative values are dropped (JAX's indexing would wrap them)
        neg = vals.copy()
        neg[::7] = -3
        np.testing.assert_array_equal(
            TT.histogram(torch.from_numpy(neg), nsym).numpy(),
            np_count(neg, np.ones(n, bool), nsym))


@pytest.mark.parametrize("nsym", [64, 19])
@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_pos_hist_matches_jax(nsym, dtype):
    """The positional form at num_rec < Rpad, on an alphabet that is a
    multiple of 8 (JAX's nibble split) and one that is not."""
    rng = np.random.default_rng(nsym)
    rpad, p, num_rec = 768, 37, 701
    mat = np.minimum(rng.geometric(0.1, (rpad, p)) - 1,
                     nsym - 1).astype(dtype)
    ref = np.asarray(JUP._pos_hist(jnp.asarray(mat), num_rec, nsym))
    got = TUP.pos_hist(torch.from_numpy(mat), num_rec, nsym)
    assert got.shape == (p, nsym) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    # a mat of another column stride (a transposed view) counts the same
    cols = torch.from_numpy(np.ascontiguousarray(mat.T)).T
    assert cols.stride(1) != 1
    np.testing.assert_array_equal(HK.pos_hist(cols, num_rec, nsym).numpy(),
                                  ref)
    keys = mat[:num_rec].astype(np.int64) + np.arange(p) * nsym
    np.testing.assert_array_equal(
        ref.reshape(-1), np.bincount(keys.reshape(-1), minlength=p * nsym))


def _decode_band_inputs(rng, lanes, t_steps, num_ctx, nsym):
    ctx = rng.integers(-3, num_ctx + 3, (lanes, t_steps)).astype(np.int32)
    sym = rng.integers(-2, nsym + 2, (lanes, t_steps)).astype(np.int32)
    lengths = rng.integers(0, t_steps + 1, lanes).astype(np.int32)
    lengths[0], lengths[-1] = 0, t_steps
    return ctx, sym, lengths


@pytest.mark.parametrize("num_ctx,nsym", [(16, 4), (4096, 64)])
def test_context_form_clips_contexts_and_drops_symbols(num_ctx, nsym):
    """bin = clamp(ctx, 0, C - 1) * A + sym, kept where 0 <= sym < A and
    t < lengths[l]: ctx_models' rule for the encode's bin ids."""
    rng = np.random.default_rng(num_ctx)
    lanes, t_steps = 48, 300
    ctx, sym, lengths = _decode_band_inputs(rng, lanes, t_steps, num_ctx,
                                            nsym)
    nbins = num_ctx * nsym
    for t0, t1 in ((0, 16), (16, 300), (100, 100), (299, 300)):
        hist = torch.zeros(nbins + 1, dtype=torch.int64)
        HK.hist_count_ctx(hist, torch.from_numpy(ctx), torch.from_numpy(sym),
                          nsym, torch.from_numpy(lengths), t0, t1)
        c, s = ctx[:, t0:t1], sym[:, t0:t1]
        ids = np.clip(c, 0, num_ctx - 1).astype(np.int64) * nsym + s
        keep = ((np.arange(t0, t1)[None, :] < lengths[:, None])
                & (s >= 0) & (s < nsym))
        np.testing.assert_array_equal(hist[:nbins].numpy(),
                                      np_count(ids, keep, nbins))


def test_context_form_equals_the_decodes_count_before_k5():
    """On decoded bands (contexts in [0, C), symbols in [0, A)) the context
    form adds what the decode's index_add_ of octx * A + osym over
    t < lengths added, and what JAX's hist_update counts; band by band
    into one histogram."""
    rng = np.random.default_rng(11)
    lanes, t_steps, num_ctx, nsym = 64, 400, 256, 16
    nbins = num_ctx * nsym
    octx = torch.from_numpy(rng.integers(0, num_ctx, (lanes, t_steps))
                            .astype(np.int32))
    osym = torch.from_numpy(np.minimum(rng.geometric(0.3, (lanes, t_steps))
                                       - 1, nsym - 1).astype(np.int32))
    lens = torch.from_numpy(rng.integers(0, t_steps + 1, lanes)
                            .astype(np.int32))
    steps = torch.arange(t_steps, dtype=torch.int32)
    got = torch.zeros(nbins + 1, dtype=torch.int64)
    before = torch.zeros(nbins + 1, dtype=torch.int64)
    ref = np.zeros(nbins, np.int64)
    for t0, t1 in zip(TC.band_edges(t_steps)[:-1], TC.band_edges(t_steps)[1:]):
        HK.hist_count_ctx(got, octx, osym, nsym, lens, t0, t1)
        ids = octx[:, t0:t1] * nsym + osym[:, t0:t1]
        keep = steps[None, t0:t1] < lens[:, None]
        ids.masked_fill_(~keep, nbins)
        before.index_add_(0, ids.reshape(-1), torch.ones(
            1, dtype=torch.int64).expand(ids.numel()))
        ref += np.asarray(JC.hist_update(
            jnp.asarray(octx[:, t0:t1].numpy() * nsym
                        + osym[:, t0:t1].numpy()),
            jnp.asarray(keep.numpy()), nbins))
        np.testing.assert_array_equal(got[:nbins].numpy(),
                                      before[:nbins].numpy())
        np.testing.assert_array_equal(got[:nbins].numpy(), ref)


def test_flat_form_with_a_2d_mask_and_every_value_type():
    rng = np.random.default_rng(3)
    nbins = 300
    ids = rng.integers(-20, nbins + 20, (37, 41))
    keep = rng.random((37, 41)) < 0.6
    want = np_count(ids, keep, nbins)
    for dt in (np.int16, np.int32, np.int64):
        np.testing.assert_array_equal(port_flat(ids.astype(dt), keep, nbins),
                                      want)
    u8 = np.clip(ids, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(port_flat(u8, keep, nbins),
                                  np_count(u8, keep, nbins))
    np.testing.assert_array_equal(port_flat(u8[:0], keep[:0], nbins),
                                  np.zeros(nbins, np.int64))


def test_ptxas_names_each_value_type_of_k5():
    """The build line's ptxas report keeps K5's routes and value types
    apart."""
    from dsrc_tpu_torch.ops import cuda_build
    anon = "_GLOBAL__N__0c1a2b3c_7_hist_cu_d4e5f6a7"
    got = [cuda_build.kernel_name(
        f"_ZN{len(anon)}{anon}{len(k)}{k}I{t}EEvNS_6ParamsEPy")
        for k, t in (("shared_kernel", "h"), ("global_kernel", "s"),
                     ("shared_kernel", "i"), ("global_kernel", "l"))]
    assert got == ["shared_kernel<uint8_t>", "global_kernel<int16_t>",
                   "shared_kernel<int32_t>", "global_kernel<int64_t>"]


def test_routes():
    assert HK.hist_route(HK.HIST_SMEM_BUDGET // 4) == "shared"
    assert HK.hist_route(HK.HIST_SMEM_BUDGET // 4 + 1) == "global"
    assert HK.hist_route(64 * 100) == "shared"
    assert HK.hist_route(256 * 256) == "global"
    assert HK.hist_route(4096 * 64) == "global"
    # too few elements a bin: the global route, which zeroes nothing, at
    # every width (the -m1 bands' 4,096 too)
    k = HK.SHARED_MIN_PER_BIN
    assert HK.hist_route(32768, k * 32768 - 1) == "global"
    assert HK.hist_route(32768, k * 32768) == "shared"
    assert HK.hist_route(6400, k * 6400 - 1) == "global"
    assert HK.hist_route(4096, 1) == "global"
    assert HK.hist_route(4096, k * 4096 - 1) == "global"
    assert HK.hist_route(4096, k * 4096) == "shared"
    assert HK.hist_route(4096 * 64, 1 << 30) == "global"
    # the value histograms take the shared route
    for nbins in (32, 256):
        assert HK.hist_route(nbins, 25 << 20) == "shared"
    # what each route holds, at the bound and one past
    budget = HK.HIST_SMEM_BUDGET // 4
    assert HK.route_holds("shared", budget)
    assert not HK.route_holds("shared", budget + 1)
    assert HK.route_holds("global", 1 << 30)
    assert HK.ROUTES == ("shared", "global")
    for nbins in (1, 32, 256, budget + 1, 1 << 18):
        for n in (None, 1, nbins, 64 * nbins):
            assert HK.hist_route(nbins, n) in HK.ROUTES
    # a forced route that cannot hold the bins raises before any launch;
    # the global route reads element by element at any width
    for route, nbins in (("shared", budget + 1), ("narrow", 10),
                         ("wide", 10)):
        with pytest.raises(DsrcException):
            HK.launch_plan(route, nbins, 100, 0, 0, 4)
    assert HK.launch_plan("global", 1 << 24, 100, 0, 0, 4) == (-1, 0)


@pytest.mark.parametrize("nsym", [64, 19])
def test_cluster_geometry_covers_the_bins(nsym):
    """k5_variants.py's cluster variant at every width too wide for the
    shared route, 58,113 to 2^18 bins, and every whole number of
    nsym-symbol contexts among them: at most CLUSTER_MAX blocks, each
    slice of 2^s bins (at least 32) within the budget, the slices
    [k << s, (k + 1) << s) cut to nbins covering [0, nbins) exactly once
    with none empty, a context's last bin owned by a block of the
    cluster; one cluster for every CLUSTER_MIN_PER_BIN elements a bin."""
    assert KV._SMEM_BUDGET == HK.HIST_SMEM_BUDGET
    lo, hi = HK.HIST_SMEM_BUDGET // 4 + 1, KV.CLUSTER_MAX << 15
    widths = np.arange(lo, hi + 1)
    geo = np.array([KV.cluster_geometry(int(w))[:3] for w in widths])
    size, shift, smem = geo.T
    assert size.max() <= KV.CLUSTER_MAX and shift.min() >= 5
    assert (smem == 4 << shift).all() and smem.max() <= HK.HIST_SMEM_BUDGET
    assert ((size << shift) >= widths).all()          # every bin owned
    assert (((size - 1) << shift) < widths).all()     # no slice empty
    # a bin b belongs to the slice of block b >> s only: starts and ends
    # of consecutive slices meet
    for w in (lo, 65_536, 131_071, 131_072, 131_073, hi):
        sz, s, _, _ = KV.cluster_geometry(w)
        edges = [min(k << s, w) for k in range(sz + 1)]
        assert edges[0] == 0 and edges[-1] == w
        assert all(a < b for a, b in zip(edges, edges[1:]))
    ctx_widths = widths[widths % nsym == 0]
    last = ctx_widths - 1                             # (C - 1) * A + A - 1
    owner = last >> shift[ctx_widths - lo]
    assert (owner < size[ctx_widths - lo]).all()
    assert all(KV.holds("cluster", int(w)) for w in (lo, hi))
    assert not KV.holds("cluster", hi + 1)
    narrow = HK.HIST_SMEM_BUDGET // 4 // KV.NARROW_COPIES
    assert KV.holds("narrow", narrow) and not KV.holds("narrow", narrow + 1)
    for w in (lo, hi):
        per = KV.CLUSTER_MIN_PER_BIN * w
        assert KV.cluster_geometry(w, 0)[3] == 1
        assert KV.cluster_geometry(w, 3 * per)[3] == 3


_H = torch.zeros(11, dtype=torch.int64)
_IDS = torch.zeros(8, dtype=torch.int32)
_C = torch.zeros((3, 5), dtype=torch.int32)
_LENS = torch.full((3,), 5, dtype=torch.int32)
_H12 = torch.zeros(13, dtype=torch.int64)
_BAD_CALLS = {
    "hist_int32": lambda: HK.hist_count(_H.to(torch.int32), _IDS),
    "hist_one_bin": lambda: HK.hist_count(torch.zeros(1, dtype=torch.int64),
                                          _IDS),
    "hist_2d": lambda: HK.hist_count(torch.zeros((2, 6), dtype=torch.int64),
                                     _IDS),
    "hist_strided": lambda: HK.hist_count(
        torch.zeros(22, dtype=torch.int64)[::2], _IDS),
    "ids_float": lambda: HK.hist_count(_H, _IDS.to(torch.float32)),
    "ids_int8": lambda: HK.hist_count(_H, _IDS.to(torch.int8)),
    "ids_strided": lambda: HK.hist_count(
        _H, torch.zeros((4, 4), dtype=torch.int32).T),
    "mask_uint8": lambda: HK.hist_count(_H, _IDS,
                                        torch.ones(8, dtype=torch.uint8)),
    "mask_shape": lambda: HK.hist_count(_H, _IDS,
                                        torch.ones(7, dtype=torch.bool)),
    "ids_bool": lambda: HK.hist_count(_H, _IDS.to(torch.bool)),
    # a tensor on another device than the CPU never takes the plain version
    "flat_off_cpu": lambda: HK.hist_count(_H.to("meta"), _IDS.to("meta")),
    "ctx_int64": lambda: HK.hist_count_ctx(_H12, _C.to(torch.int64), _C, 4,
                                           _LENS, 0, 5),
    "ctx_shapes": lambda: HK.hist_count_ctx(_H12, _C, _C[:, :4], 4, _LENS,
                                            0, 4),
    "ctx_lengths": lambda: HK.hist_count_ctx(_H12, _C, _C, 4, _LENS[:2], 0,
                                             5),
    "ctx_rows": lambda: HK.hist_count_ctx(_H12, _C, _C, 5, _LENS, 0, 5),
    "ctx_band_reversed": lambda: HK.hist_count_ctx(_H12, _C, _C, 4, _LENS,
                                                   3, 2),
    "ctx_band_past_end": lambda: HK.hist_count_ctx(_H12, _C, _C, 4, _LENS,
                                                   0, 6),
    "ctx_strided": lambda: HK.hist_count_ctx(_H12, _C.T.contiguous().T, _C,
                                             4, _LENS, 0, 5),
    "ctx_off_cpu": lambda: HK.hist_count_ctx(
        _H12.to("meta"), _C.to("meta"), _C.to("meta"), 4, _LENS.to("meta"),
        0, 5),
    "pos_3d": lambda: HK.pos_hist(_C[None], 1, 4),
    "pos_no_symbols": lambda: HK.pos_hist(_C, 2, 0),
    "pos_rows": lambda: HK.pos_hist(_C, 4, 4),
    "pos_float": lambda: HK.pos_hist(_C.to(torch.float32), 2, 4),
    "pos_off_cpu": lambda: HK.pos_hist(_C.to("meta"), 2, 4),
}


@pytest.mark.parametrize("case", list(_BAD_CALLS))
def test_wrapper_checks_raise(case):
    with pytest.raises(DsrcException):
        _BAD_CALLS[case]()


def mirror_bins(vals, ld, t0, rows, cols, hi_kind, nsym, nctx, nbins,
                ctx=None, mask=None, lengths=None, elems=None):
    """csrc/hist.cu's element rule in numpy: the bins of the kept elements
    among `elems` (indices r * cols + c; all when None), reading each
    input at the storage offset r * ld + t0 + c its launch arguments
    give."""
    e = np.arange(rows * cols) if elems is None else np.asarray(elems)
    r, c = e // cols, e % cols
    o = r * ld + t0 + c

    def at(t):
        return t.reshape(-1).numpy()[o] if t.is_contiguous() else \
            t.as_strided((t.untyped_storage().nbytes() // t.element_size()
                          - t.storage_offset(),), (1,)).numpy()[o]
    v = at(vals).astype(np.int64)
    keep = np.ones(o.shape, bool)
    if mask is not None:
        keep &= at(mask)
    if lengths is not None:
        keep &= t0 + c < lengths.numpy()[r]
    a = nbins if hi_kind == 0 else nsym
    keep &= (v >= 0) & (v < a)
    hi = (0 if hi_kind == 0 else c if hi_kind == 1
          else np.clip(at(ctx), 0, nctx - 1))
    return (hi * a + v)[keep]


def kernel_mirror(hist, vals, ld, t0, rows, cols, hi_kind, nsym, nctx,
                  nbins, ctx=None, mask=None, lengths=None):
    """The element rule's counts of one launch added into hist."""
    np.add.at(hist, mirror_bins(vals, ld, t0, rows, cols, hi_kind, nsym,
                                nctx, nbins, ctx, mask, lengths), 1)


def routes_of(nbins):
    """The routes of hist_kernels and the variants of k5_variants.py that
    can hold nbins bins."""
    return [r for r in HK.ROUTES if HK.route_holds(r, nbins)] + [
        v for v in KV.VARIANTS if KV.holds(v, nbins)]


def route_mirror(route, vals, ld, t0, rows, cols, hi_kind, nsym, nctx,
                 nbins, ctx=None, mask=None, lengths=None):
    """The counts one launch on `route` (a route of hist_kernels or a
    variant of k5_variants.py) makes, read through its launch arguments
    (launch_plan or variant_plan, from the tensors' addresses): a flat
    call's scalar head, vector chunks and scalar tail, or a context
    band's quads of steps, which must cover its elements once from
    aligned addresses, and on the cluster variant each block's slice of
    the bins, counted apart and added, as each block flushes its own."""
    n = rows * cols
    mask_addr = None if mask is None else mask.data_ptr()
    ctx_addr = 0 if ctx is None else ctx.data_ptr()
    args = (nbins, n, hi_kind, vals.data_ptr(), vals.element_size(),
            mask_addr, ctx_addr, t0, cols, ld)
    if route in KV.VARIANTS:
        head, size, shift, clusters, quads = KV.variant_plan(route, *args)
    else:
        (head, quads), size, shift, clusters = \
            HK.launch_plan(route, *args), 0, 0, 0
    parts = [None]
    if quads:
        assert hi_kind == 2 and route != "global" and head == -1
        assert cols % 4 == 0 and t0 % 4 == 0 and ld % 4 == 0
        e = np.arange(0, n, 4)
        starts = (e // cols) * ld + t0 + e % cols
        for addr in (vals.data_ptr(), ctx_addr):
            assert ((addr + 4 * starts) % 16 == 0).all()
        parts = [(e[:, None] + np.arange(4)).reshape(-1)]
        assert np.array_equal(parts[0], np.arange(n))
    if head >= 0:
        assert 0 <= head < 16 and hi_kind == 0 and rows == 1
        stop = head + (n - head) // 16 * 16
        parts = [np.arange(head), np.arange(head, stop), np.arange(stop, n)]
        assert np.array_equal(np.concatenate(parts), np.arange(n))
        assert len(parts[2]) < 16
        assert (vals.data_ptr() + head * vals.element_size()) % 16 == 0
        assert mask is None or (mask_addr + head) % 16 == 0
    bins = np.concatenate([mirror_bins(vals, ld, t0, rows, cols, hi_kind,
                                       nsym, nctx, nbins, ctx, mask, lengths,
                                       elems) for elems in parts])
    if route != "cluster":
        assert size == shift == clusters == 0
        return np.bincount(bins, minlength=nbins)
    assert 1 <= size <= KV.CLUSTER_MAX and clusters >= 1
    assert (4 << shift) <= HK.HIST_SMEM_BUDGET
    rank = bins >> shift
    assert bins.size == 0 or rank.max() < size
    got = np.zeros(size << shift, np.int64)
    for k in range(size):
        got[k << shift:(k + 1) << shift] += np.bincount(
            bins[rank == k] - (k << shift), minlength=1 << shift)
    assert not got[nbins:].any()
    return got[:nbins]


def _launches_of(monkeypatch, call, real):
    """The K5 launches `call` makes on meta tensors (so that the wrapper
    goes past the plain version), with each meta tensor replaced by its
    real CPU twin from `real` ({id(meta): cpu tensor}; a histogram the
    wrapper makes itself stays on meta)."""
    made = []
    monkeypatch.setattr(HK, "_launch", lambda *a, **k: made.append((a, k)))
    call()
    monkeypatch.undo()
    swap = lambda t: real.get(id(t), t) if isinstance(t, torch.Tensor) \
        else t  # noqa: E731
    return [([swap(x) for x in a], {k: swap(v) for k, v in kw.items()})
            for a, kw in made]


def test_launch_arguments_count_what_the_plain_versions_count(monkeypatch):
    """Each form's launch arguments (view, row stride, first column, kind,
    bins), read by a mirror of the kernel's element rule, give the plain
    version's counts."""
    rng = np.random.default_rng(8)
    real = {}

    def meta(t):
        m = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                device="meta")
        real[id(m)] = t
        return m

    nbins = 500
    ids = torch.from_numpy(rng.integers(-9, nbins + 9, (23, 31))
                           .astype(np.int16))
    keep = torch.from_numpy(rng.random((23, 31)) < 0.6)
    hist_m = meta(torch.zeros(nbins + 1, dtype=torch.int64))
    ids_m, keep_m = meta(ids), meta(keep)
    cases = [("flat", lambda: HK.hist_count(hist_m, ids_m, keep_m),
              lambda h: HK.hist_count_plain(h, ids, keep))]

    num_ctx, nsym, lanes, t_steps = 40, 8, 17, 90
    octx = torch.from_numpy(rng.integers(-2, num_ctx + 2, (lanes, t_steps))
                            .astype(np.int32))
    osym = torch.from_numpy(rng.integers(-1, nsym + 1, (lanes, t_steps))
                            .astype(np.int32))
    lens = torch.from_numpy(rng.integers(0, t_steps + 1, lanes)
                            .astype(np.int32))
    hc_m = meta(torch.zeros(num_ctx * nsym + 1, dtype=torch.int64))
    octx_m, osym_m, lens_m = meta(octx), meta(osym), meta(lens)
    cases.append(("context", lambda: HK.hist_count_ctx(
        hc_m, octx_m, osym_m, nsym, lens_m, 13, 71),
        lambda h: HK.hist_count_ctx_plain(h, octx, osym, nsym, lens, 13,
                                          71)))

    wide = torch.from_numpy(rng.integers(0, 19, (300, 30)).astype(np.uint8))
    mat = wide[:, :23]                      # row stride 30, unit columns
    mat_m = meta(mat)
    cases.append(("positional", lambda: HK.pos_hist(mat_m, 271, 19),
                  lambda h: h[:-1].copy_(HK.pos_hist_plain(mat, 271, 19)
                                         .reshape(-1))))
    for name, call, plain in cases:
        launches = _launches_of(monkeypatch, call, real)
        assert len(launches) == 1, name
        (_, hist, vals, ld, t0, rows, cols, hi_kind, nsym_, nctx,
         nb), kw = launches[0]
        got = np.zeros(nb, np.int64)
        kernel_mirror(got, vals, ld, t0, rows, cols, hi_kind, nsym_, nctx,
                      nb, **kw)
        want = torch.zeros(nb + 1, dtype=torch.int64)
        plain(want)
        np.testing.assert_array_equal(got, want[:nb].numpy(), err_msg=name)
        for route in routes_of(nb):
            np.testing.assert_array_equal(
                route_mirror(route, vals, ld, t0, rows, cols, hi_kind,
                             nsym_, nctx, nb, **kw),
                want[:nb].numpy(), err_msg=f"{name} {route}")


def _meta_twin(real):
    def meta(t):
        m = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                device="meta")
        real[id(m)] = t
        return m
    return meta


_VIEW_CASES = ["flat_base_plus_one", "flat_mask_disagrees", "flat_17",
               "flat_cluster_widths", "context_odd_band",
               "context_quads", "context_cluster_widths",
               "positional_row_stride"]


@pytest.mark.parametrize("case", _VIEW_CASES)
def test_route_launch_arguments_count_what_the_plain_versions_count(
        monkeypatch, case):
    """The views the vector reads and the cluster variant's slices make
    hard: a base one element past an aligned address (its mask's address
    agreeing or not), 17 elements, a context band at an odd first column
    and one read by quads (first column, width and row stride multiples
    of 4), positional rows of stride past P, the quality contexts' widths
    (nsym 64 and 19).  Each launch, read through the arguments of each
    route and variant that holds its bins by route_mirror, gives the
    plain version's counts."""
    rng = np.random.default_rng(len(case))
    real = {}
    meta = _meta_twin(real)
    if case.startswith("flat"):
        nbins = {"flat_cluster_widths": 4099 * 64}.get(case, 200)
        n = {"flat_17": 17, "flat_cluster_widths": 70_001}.get(case, 5_003)
        for dt in (np.uint8, np.int16, np.int32, np.int64):
            ids = torch.from_numpy(rng.integers(-3, min(nbins + 9, 255),
                                                n + 1).astype(dt))
            keep = torch.from_numpy(rng.random(n + 1) < 0.7)
            cut = (0, 0) if case == "flat_17" else \
                (1, 0) if case == "flat_mask_disagrees" else (1, 1)
            v, m = ids[cut[0]:cut[0] + n], keep[cut[1]:cut[1] + n]
            hist_m = meta(torch.zeros(nbins + 1, dtype=torch.int64))
            v_m, m_m = meta(v), meta(m)
            _check_route_launch(monkeypatch, real, f"{case} {dt}",
                                lambda: HK.hist_count(hist_m, v_m, m_m),
                                lambda h: HK.hist_count_plain(h, v, m))
        return
    if case.startswith("context"):
        band = (16, 64) if case == "context_quads" else (13, 71)
        for num_ctx, nsym in ((40, 8), (3059, 19), (4096, 64)) if \
                case == "context_cluster_widths" else ((40, 8),):
            lanes, t_steps = 17, 96
            octx = torch.from_numpy(rng.integers(
                -2, num_ctx + 2, (lanes, t_steps)).astype(np.int32))
            osym = torch.from_numpy(rng.integers(
                -1, nsym + 1, (lanes, t_steps)).astype(np.int32))
            lens = torch.from_numpy(rng.integers(0, t_steps + 1, lanes)
                                    .astype(np.int32))
            nbins = num_ctx * nsym
            hc_m = meta(torch.zeros(nbins + 1, dtype=torch.int64))
            o_m, s_m, l_m = meta(octx), meta(osym), meta(lens)
            _check_route_launch(
                monkeypatch, real, f"{case} {nbins}",
                lambda: HK.hist_count_ctx(hc_m, o_m, s_m, nsym, l_m, *band),
                lambda h: HK.hist_count_ctx_plain(h, octx, osym, nsym, lens,
                                                  *band))
        return
    for p, nsym in ((4, 64), (37, 19), (1, 19)):
        wide = torch.from_numpy(rng.integers(0, nsym, (300, p + 5))
                                .astype(np.int16))
        mat = wide[:, :p]
        mat_m = meta(mat)
        _check_route_launch(
            monkeypatch, real, f"{case} P={p}",
            lambda: HK.pos_hist(mat_m, 271, nsym),
            lambda h: h[:-1].copy_(HK.pos_hist_plain(mat, 271, nsym)
                                   .reshape(-1)))


def _check_route_launch(monkeypatch, real, name, call, plain):
    launches = _launches_of(monkeypatch, call, real)
    assert len(launches) == 1, name
    (_, hist, vals, ld, t0, rows, cols, hi_kind, nsym, nctx, nb), kw = \
        launches[0]
    want = torch.zeros(nb + 1, dtype=torch.int64)
    plain(want)
    routes = routes_of(nb)
    assert "global" in routes and ("cluster" in routes) == (nb <= 1 << 18)
    if name.startswith("context_quads"):
        assert HK.launch_plan("shared", nb, rows * cols, hi_kind,
                              vals.data_ptr(), 4, None, kw["ctx"].data_ptr(),
                              t0, cols, ld)[1] == 1
    for route in routes:
        np.testing.assert_array_equal(
            route_mirror(route, vals, ld, t0, rows, cols, hi_kind, nsym,
                         nctx, nb, **kw),
            want[:nb].numpy(), err_msg=f"{name} {route}")
