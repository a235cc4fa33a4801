"""Seconds of ``QueryEngine(...)`` over the generated store, ended by
``torch.cuda.synchronize()``: the upload, the length buckets and the query
layout built on the card (its stages print on an earlier line)."""


def read(run):
    return run.engine_init_s
