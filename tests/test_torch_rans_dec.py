"""K2's host-side pieces on the CPU: the shared-memory layout the wrapper
hands the kernel, the kernel's symbol rule (a count of the row entries
<= slot, written out in plain PyTorch) against the binary search of
rans_decode_plain, and the ptxas log reader of the kernel build.
"""
import numpy as np
import pytest
import torch

from dsrc_tpu_torch.ops import cuda_build
from dsrc_tpu_torch.ops import rans_kernels as RK
from dsrc_tpu_torch.ops.rans import M, cum_from_freqs
from torch_threads import one_torch_thread  # noqa: F401


def _rows(nsym, rng):
    """Non-decreasing cum rows of nsym symbols: full tables, tables with
    runs of zero-frequency symbols, an all-zero row, a table whose total is
    below 2^14 (cum[nsym] <= some slots), single-symbol tables."""
    freqs = [rng.multinomial(M, np.ones(nsym) / nsym)]
    z = rng.multinomial(M, rng.dirichlet(np.full(nsym, 0.3)))
    z[rng.random(nsym) < 0.5] = 0
    freqs += [z, np.zeros(nsym, np.int64)]
    freqs.append(rng.integers(0, 2 * M // nsym + 2, nsym))
    for at in (0, nsym - 1, nsym // 2):
        one = np.zeros(nsym, np.int64)
        one[at] = M
        freqs.append(one)
    return cum_from_freqs(torch.from_numpy(np.stack(freqs).astype(np.int32)))


@pytest.mark.parametrize("nsym", [1, 2, 3, 17, 32, 33, 34, 63, 64, 65, 97,
                                  128, 129, 200, 256, 257, 511, 512, 600])
def test_count_search_equals_binary_search_on_every_slot(nsym):
    rng = np.random.default_rng(nsym)
    cum = _rows(nsym, rng)
    p = cum.shape[0]
    slots = np.arange(1 << 14, dtype=np.int64)
    # high state bits must not reach the slot
    states = slots | (rng.integers(0, 1 << 18, slots.size) << 14)
    states = torch.from_numpy(states.astype(np.uint32).view(np.int32))
    lanes = states.shape[0]
    # num_rec = 0: the state is held, so step t reads row t with the same
    # slot and the plain version's output is its binary search per row
    ref = RK.rans_decode_plain(
        torch.zeros((lanes, 1), dtype=torch.int32), states,
        torch.zeros(lanes, dtype=torch.int32), cum, 0, 1)
    got = RK.count_search_plain(
        cum, torch.from_numpy(slots)[:, None].expand(lanes, p))
    assert torch.equal(got.to(torch.int32), ref)
    assert int(got.min()) >= 0 and int(got.max()) < nsym


@pytest.mark.parametrize("nsym,p,ne,stride,tile_rows", [
    (1, 7, 0, 2, 7), (2, 7, 1, 33, 7), (33, 3, 1, 34, 3),
    (64, 100, 2, 65, 100),                 # SEMI quality
    (128, 52, 4, 129, 52),                 # UNIFORM titles
    (256, 7, 8, 257, 7),                   # SEMI value planes
    (512, 2048, 16, 513, (64 * 1024) // (4 * 513)),
    (600, 4, 19, 609, 4)])
def test_dec_layout(nsym, p, ne, stride, tile_rows):
    assert RK.dec_layout(nsym, p) == (ne, stride, tile_rows)
    # every compared entry lies inside the padded row
    assert 32 * ne + 1 <= stride and nsym + 1 <= stride
    assert tile_rows * stride * 4 <= max(RK.DEC_SMEM_BUDGET, stride * 4)


def test_dec_layout_takes_at_least_one_row_a_tile():
    assert RK.dec_layout(512, 2048, budget=100)[2] == 1
    assert RK.dec_layout(20000, 3) == (625, 20001, 1)


_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__c27f8bd9_11_rans_dec_cu_8f53b51718rans_decode_kernelILin1EEEvPKiiPKjS2_S2_iiiiiiiiPi' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__c27f8bd9_11_rans_dec_cu_8f53b51718rans_decode_kernelILin1EEEvPKiiPKjS2_S2_iiiiiiiiPi
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 412 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__c27f8bd9_11_rans_dec_cu_8f53b51718rans_decode_kernelILi2EEEvPKiiPKjS2_S2_iiiiiiiiPi' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__c27f8bd9_11_rans_dec_cu_8f53b51718rans_decode_kernelILi2EEEvPKiiPKjS2_S2_iiiiiiiiPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, 1024 bytes smem, 412 bytes cmem[0]
"""


def test_ptxas_usage_reads_every_kernel():
    usage = cuda_build.ptxas_usage(_LOG)
    assert usage == {
        "rans_decode_kernel<-1>": {"registers": 40, "smem_bytes": 0,
                                   "spill_stores": 4, "spill_loads": 8},
        "rans_decode_kernel<2>": {"registers": 32, "smem_bytes": 1024,
                                  "spill_stores": 0, "spill_loads": 0}}
    assert cuda_build.kernel_name("plain_c_name") == "plain_c_name"
    assert cuda_build.kernel_name(
        "_ZN44_GLOBAL__N__7ef3696d_11_rans_enc_cu_33df57a318rans_encode_kernel"
        "EPKiS1_PKhiiiPtPiPj") == "rans_encode_kernel"
