"""K5, the port's histogram (dsrc_tpu_torch/ops/hist_kernels.py), against
the JAX package's histograms and a numpy count, on the CPU (where the
wrappers run their plain PyTorch versions).

The JAX functions: ops/ctx.hist_update (its matrix-unit branch up to
2^18 bins, its scatter branch beyond), parallel/uniform_pipeline._pos_hist
and ops/transform.histogram.  Counts are exact integers, so every
comparison is exact equality.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    """The build line's ptxas report keeps K5's instantiations apart."""
    from dsrc_tpu_torch.ops import cuda_build
    anon = "_GLOBAL__N__0c1a2b3c_7_hist_cu_d4e5f6a7"
    stem = f"_ZN{len(anon)}{anon}11hist_kernelI"
    got = [cuda_build.kernel_name(stem + t + "EEEvNS_6ParamsEPy")
           for t in ("hLb1", "sLb0", "iLb1", "lLb0")]
    assert got == ["hist_kernel<uint8_t,true>", "hist_kernel<int16_t,false>",
                   "hist_kernel<int32_t,true>", "hist_kernel<int64_t,false>"]


def test_routes():
    assert HK.hist_route(HK.HIST_SMEM_BUDGET // 4) == "shared"
    assert HK.hist_route(HK.HIST_SMEM_BUDGET // 4 + 1) == "global"
    assert HK.hist_route(64 * 100) == "shared"
    assert HK.hist_route(256 * 256) == "global"
    assert HK.hist_route(4096 * 64) == "global"
    # too few elements a bin: the global route, which zeroes nothing,
    # except for a histogram of SHARED_ANY_BINS bins or fewer
    k = HK.SHARED_MIN_PER_BIN
    assert HK.hist_route(32768, k * 32768 - 1) == "global"
    assert HK.hist_route(32768, k * 32768) == "shared"
    assert HK.hist_route(6400, k * 6400 - 1) == "global"
    any_bins = HK.SHARED_ANY_BINS
    assert HK.hist_route(any_bins, 1) == "shared"
    assert HK.hist_route(any_bins + 1, k * (any_bins + 1) - 1) == "global"
    assert HK.hist_route(4096 * 64, 1 << 30) == "global"


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


def kernel_mirror(hist, vals, ld, t0, rows, cols, hi_kind, nsym, nctx,
                  nbins, ctx=None, mask=None, lengths=None):
    """csrc/hist.cu's element rule in numpy, reading each input at the
    storage offset r * ld + t0 + c its launch arguments give."""
    r = np.repeat(np.arange(rows), cols)
    c = np.tile(np.arange(cols), rows)
    o = r * ld + t0 + c

    def at(t):
        return t.reshape(-1).numpy()[o] if t.is_contiguous() else \
            t.as_strided((t.untyped_storage().nbytes() // t.element_size(),),
                         (1,), 0).numpy()[o]
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
    np.add.at(hist, (hi * a + v)[keep], 1)


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
