"""K2, the conditional-CDF inversion of the MERL sampling
(`csrc/cond_sample.cu`, the JAX package's `ops/marginal_sorted._cond_kernel`):
for each live lane, the column of one 64-float conditional CDF row at a
uniform, and three cell masses of that slice.

Logical work of one call: a live lane's slice key, row and two cell
indices (5 x 4 B) and its uniform (4 B); one 64-float CDF row a live lane,
at most the whole stack of CDFs the call is handed (the JAX kernel's own
input); a mask byte and 4 outputs (16 B) a lane. Operations: 220 a live
lane; the inversion is bound by its bytes.
"""

TRACE_NAME = "cond_sample_kernel"
WRAPPER = ("mitsuba_customization_tpu_torch.ops.marginal_sorted", "cond_sample_pdf")
OPS = 220
ROW_BYTES = 256


def record(args, kwargs, out):
    """The logical counts of one call, read from its arguments."""
    cdf, valid = args[0], args[-1]
    return {"lanes": int(valid.shape[0]), "live": int(valid.sum()),
            "cdf_bytes": int(cdf.numel()) * 4}


def work(call):
    """(bytes, operations) of one recorded call."""
    nbytes = (min(call["cdf_bytes"], call["live"] * ROW_BYTES) + call["live"] * (5 * 4 + 4)
              + call["lanes"] * (1 + 16))
    return nbytes, call["live"] * OPS
