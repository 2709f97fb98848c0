"""Distributed compression of the port on the CPU:
DsrcModule(device="cpu").compress(..., distributed=True) in four processes
of a gloo group writes the single-process archive byte for byte.

- (a) a SEMI file (title mode 2), whose archive also equals dsrc_tpu's;
- (b) a file whose block 0 is UNIFORM and whose later blocks are SEMI:
  the reference's parallel/distributed.py seeds the semi hints from block
  0, which gives other hints here; the port seeds them from the blocks
  that seed them in one process (each process asks its own blocks,
  BlockCodec.semi_hint_seeds, and an all-gather takes the lowest);
- (c) a small -d2 -q2 GENERIC file.

Each archive decompresses to its input.  Without a process group, or with
stream arguments, distributed=True raises DsrcException.
"""
import io
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from dsrc_tpu import api as JAPI
from dsrc_tpu.config import InputParameters as JaxParams
from dsrc_tpu.models import block as JB
from dsrc_tpu_torch import api as TAPI
from dsrc_tpu_torch.api import DsrcModule
from dsrc_tpu_torch.config import DsrcException, InputParameters
from dsrc_tpu_torch.io.chunker import FastqChunker
from dsrc_tpu_torch.models import block as TB
from dsrc_tpu_torch.parallel import distributed as TD
from dsrc_tpu_torch.utils.synth import make_fastq_fast, make_fastq_realistic
from torch_jax_codec import jax_codec  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 1 << 17
WORLD = 4
# each worker process is killed after this many seconds
WORKER_TIMEOUT = 45
CASES = {"semi": {}, "uniform_then_semi": {},
         "generic": dict(dna_compression_level=2,
                         quality_compression_level=2)}

WORKER = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, port, tmp = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    from dsrc_tpu_torch.api import DsrcModule
    from dsrc_tpu_torch.config import InputParameters
    for name, kw in CASES.items():
        DsrcModule(InputParameters(fastq_block_size_bytes=BLOCK, **kw),
                   device="cpu").compress(f"{tmp}/{name}.fastq",
                                          f"{tmp}/{name}.xfqz",
                                          distributed=True)
    dist.destroy_process_group()
    assert not any(m.split(".")[0] in ("jax", "dsrc_tpu")
                   for m in sys.modules)
    print(f"rank {rank}: distributed compress DONE", flush=True)
""")


def _uniform_block() -> bytes:
    """2,048 fixed-width records of 64 bytes: one UNIFORM block of exactly
    BLOCK bytes (titles r0000000.., reads of 25 bases)."""
    rng = np.random.default_rng(3)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (2048, 25))]
    qual = rng.integers(35, 75, (2048, 25)).astype(np.uint8)
    out = b"".join(b"@r%07d\n%s\n+\n%s\n" % (i, s.tobytes(), q.tobytes())
                   for i, (s, q) in enumerate(zip(seq, qual)))
    assert len(out) == BLOCK
    return out


def _inputs():
    return {"semi": make_fastq_fast(4000, 60, seed=21, fixed_width=False),
            "uniform_then_semi": _uniform_block()
            + make_fastq_fast(3000, 60, seed=22, fixed_width=False),
            "generic": make_fastq_realistic(1200, 100, seed=23)}


def _port(name):
    return DsrcModule(InputParameters(fastq_block_size_bytes=BLOCK,
                                      **CASES[name]), device="cpu")


@pytest.fixture(scope="module")
def distributed_run(tmp_path_factory):
    """Each case's input, written to a directory that four gloo processes
    then compress into with distributed=True."""
    tmp = tmp_path_factory.mktemp("distributed")
    data = _inputs()
    for name, d in data.items():
        (tmp / f"{name}.fastq").write_bytes(d)
    worker = tmp / "worker.py"
    worker.write_text(f"CASES = {CASES!r}\nBLOCK = {BLOCK}\n" + WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), str(WORLD), str(port),
         str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, cwd=str(tmp)) for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=WORKER_TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
        assert "distributed compress DONE" in out
    return {name: (d, (tmp / f"{name}.xfqz").read_bytes())
            for name, d in data.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_distributed_archive_equals_single_process(distributed_run, name):
    data, dist_arch = distributed_run[name]
    one = io.BytesIO()
    _port(name).compress(io.BytesIO(data), one)
    assert dist_arch == one.getvalue()
    out = io.BytesIO()
    _port(name).decompress(io.BytesIO(dist_arch), out)
    assert out.getvalue() == data


def test_semi_distributed_archive_equals_jax(distributed_run, jax_codec,
                                             monkeypatch):
    """dsrc_tpu's single-process archive, through its per-block codec (its
    mesh path writes the same bytes, tests/test_parallel.py)."""
    data, dist_arch = distributed_run["semi"]
    monkeypatch.setattr(JAPI, "_mesh_compress_results", lambda *a: None)
    jarch = io.BytesIO()
    with jax_codec():
        JAPI.DsrcModule(JaxParams(fastq_block_size_bytes=BLOCK,
                                  num_workers=1)).compress(
            io.BytesIO(data), jarch)
    assert dist_arch == jarch.getvalue()


def test_block0_hints_differ_from_the_planner():
    """Input (b) shows the reference's fault: its distributed compression
    seeds the hints from block 0 (seed_semi_hints), which here are not the
    hints of a single-process run; the port's planner gives that run's."""
    data = _inputs()["uniform_then_semi"]
    blocks = list(FastqChunker(io.BytesIO(data), BLOCK))
    assert blocks[0].tobytes() == _uniform_block()
    settings = InputParameters().to_settings()
    shape = TB.BlockShape.for_block_size(BLOCK)
    ds = TAPI.analyze_first_block(blocks[0], shape, device="cpu")
    assert TB.stage_uniform_block(blocks[0], shape.cap, "cpu") is not None
    one = TB.BlockCodec(shape, settings, ds, "cpu")
    for i, b in enumerate(blocks):
        one.compress(b, i)
    plan = TB.BlockCodec(shape, settings, ds, "cpu")
    per_rank = np.stack([TD.own_hint_seeds(
        plan, {i: b for i, b in enumerate(blocks) if i % WORLD == r})
        for r in range(WORLD)])
    plan.set_semi_hints(*TD.file_hint_seeds(per_rank))
    hints = (plan._rpad_hint, plan._pcs_hint)
    assert hints == (one._rpad_hint, one._pcs_hint)
    jcodec = JB.BlockCodec(JB.BlockShape.for_block_size(BLOCK), settings,
                           JAPI.analyze_first_block(
                               blocks[0], JB.BlockShape.for_block_size(BLOCK)))
    jcodec.seed_semi_hints(blocks[0])
    assert jcodec._rpad_hint != hints[0]
    assert jcodec._pcs_hint != hints[1]


def test_distributed_needs_a_process_group_and_file_paths(tmp_path):
    import torch.distributed as dist
    assert not dist.is_initialized()
    src = tmp_path / "in.fastq"
    src.write_bytes(make_fastq_fast(100, 50, seed=1))
    mod = _port("semi")
    with pytest.raises(DsrcException, match="init_process_group"):
        mod.compress(str(src), str(tmp_path / "out.xfqz"), distributed=True)
    with pytest.raises(DsrcException, match="file paths"):
        mod.compress(io.BytesIO(src.read_bytes()), str(tmp_path / "o"),
                     distributed=True)
