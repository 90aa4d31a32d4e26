"""prep_s: host seconds of graph prep (the stand-in graph loaded, the
port's CSR built, its ordering computed and applied, sym_norm_adjacency)."""


def read(r):
    return r["prep_s"]
