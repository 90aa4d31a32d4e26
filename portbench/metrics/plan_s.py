"""plan_s: host seconds of spmm_plan (with Aᵀ's plan for training), up to
a synchronize."""


def read(r):
    return r["plan_s"]
