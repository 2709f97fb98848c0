"""stage_ms_per_MiB.<stage>.<op>: the program's own spans (its recorder,
dsrc_tpu_torch/utils/trace.py): the self ms of codec.<stage> below
BlockCodec's codec.<op> span, summed over the operations, a FASTQ MiB;
<stage> one of stage, tag, model, sync, serialize, and other (the self time
of codec.<op>).  The six add up to the codec's ms a MiB (layer: models.block,
the block codec on host and device; model and sync: its device work)."""
from yardstick import program


def read(run, part):
    stage, op = part.split(".")
    return program.stage_ms_per_mib(run, stage, op)
