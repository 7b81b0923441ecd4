"""Published peaks of one NVIDIA H100, and the group-by kernel's least time.

Frozen copy of chip_smoke.py's `HBM_BYTES_PER_S`, `F32_OPS_PER_S` and
`bound()` (its phase 3), unchanged but for this header and the docstring.
The rates are NVIDIA's data sheet for the H100 SXM at its full power limit
of 700 W; a run states the card's own limit beside any share of them."""

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
F32_OPS_PER_S = 67e12  # H100 SXM published float32 rate outside tensor cores


def bound(R, G, Ms, Mn, Mx):
    """Least time the card could take for one launch of the group-by
    kernel over R rows, G groups, Ms sums, Mn mins and Mx maxes: each input
    byte read once, each output written once, at the HBM rate; against one
    add or compare per row and column at the float32 rate.  Returns (ms,
    bound_by)."""
    nbytes = R * (4 + 1 + 4 * Ms + 5 * (Mn + Mx)) + 4 * G * (Ms + Mn + Mx)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = R * (Ms + Mn + Mx) / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
