"""api_ms_per_MiB.<span>.<op>: the program's own api.<span> spans (its
recorder, dsrc_tpu_torch/utils/trace.py), their durations summed over the
operations' calls, in ms a FASTQ MiB: api.read is the reader thread's next
block from the chunker or the archive, api.write a block written to the
archive or the FASTQ output on the calling thread (layer: api, DsrcModule
and the worker pipeline)."""
from yardstick import program


def read(run, part):
    span, op = part.split(".")
    return program.span_ms_per_mib(run, "api." + span, op)
