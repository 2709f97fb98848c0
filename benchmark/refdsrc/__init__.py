"""The benchmark's plain reference decoder of `.xfqz` archives: a frozen
copy of the decode path of dsrc_tpu_torch as it stood at commit 2029733,
run on the CPU only, where every kernel wrapper takes its plain PyTorch
version.  It imports nothing of the program: a later change to the
program's codec does not change the reference that judges it.
ops/cuda_build.py here loads no kernel, so a CUDA tensor that reached a
wrapper would raise; utils/native.py finds no host library beside this
copy and runs its numpy fallbacks.

Only what io.archive.ArchiveReader and models.block.BlockCodec (its
constructor, BlockShape.for_block_size and BlockCodec.decompress) reach
is kept, every decode path of the container with it (UNIFORM, SEMI title
modes 0 and 2, GENERIC at every -d/-q level, A19, colour space, lossy
binning, '+' repetition).  Each function and method kept, but the stub
ops/cuda_build.load, is byte for byte as at 2029733, so `git show 2029733:dsrc_tpu_torch/<file>` diffs against
it; module docstrings are kept as they were.  Dropped: every encoder and
what only they reach (BlockCodec.compress and its staging, serialization
and semi hints, BlockCodec.verify_checksum, the archive writer,
encode_tags / encode_quality / encode_dna and their analyses, the rANS
encode (K1) and its plain version, the flat and positional histograms of
K5 (hist_count, pos_hist), ops/parser.py, the host library's encode-side
staging), config.InputParameters and FieldMask, then the imports and
constants nothing kept uses.

Used by yardstick/check.py: io.archive.ArchiveReader parses the container,
models.block.BlockCodec(..., device="cpu").decompress decodes a block.
"""
