"""Examples of the port's library surface: example1 (whole-file API),
example2 (record API).  Run them as modules, e.g.

    python -m dsrc_tpu_torch.examples.example1 in.fastq out.xfqz rt.fastq
"""
