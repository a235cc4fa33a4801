from memo_tpu_torch.io.fasta import FastaRecord, read_fasta, reverse_complement, write_fai  # noqa: F401
