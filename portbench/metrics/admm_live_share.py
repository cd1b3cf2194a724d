"""The share of the ADMM lane-iterations launched in the traced window that
fell on live lanes, in percent: the program's window records
(``gpmpc_tpu_torch.ops.qp.admm.TRACE_RECORDS``, one a solve while the
profiler runs) give Σ iterations of each lane over Σ lanes · (chunks ·
interval + tail). The rest ran on lanes already frozen."""


def read(data):
    try:
        from gpmpc_tpu_torch.ops.qp import admm
    except ImportError:
        return None
    records = getattr(admm, "TRACE_RECORDS", None)
    if not records:
        return None
    launched = sum(r["lanes"] * (r["chunks"] * r["interval"] + r["tail"]) for r in records)
    if not launched:
        return None
    live = sum(int(r["iterations"].sum()) for r in records)
    return 100.0 * live / launched
