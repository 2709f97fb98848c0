"""read_ahead.<op>: the program's count api.read_ahead (its recorder,
dsrc_tpu_torch/utils/trace.py; parallel/pipeline.py), the blocks or archive
blobs that the reader thread had queued when block 0's job returned on the
calling thread, a call, averaged over the operations' calls (layer: api,
DsrcModule and the worker pipeline)."""
from yardstick import program


def read(run, part):
    got = program.call_counts(run, "api.read_ahead", part)
    return None if not got else sum(n for n, _ in got) / len(got)
