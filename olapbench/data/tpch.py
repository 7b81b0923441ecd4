"""The TPC-H lineitem star subset, drawn from a seed on the device.

Frozen copy of the value distributions of
spark_druid_olap_tpu_torch/workloads/tpch.py (`gen_tables`, `_geo`) and of
its flat layout (`DIM_ATTRS`, `FLAT_METRICS`, `flat_columns`, `register`).
Changed here: every table is drawn with one `torch.Generator` on the device
in a few large calls instead of numpy on the host; parts take TPC-H's 150
types (the port's generator has 5); string attributes are
held as ids into fixed name lists; lineitem is sorted by `l_shipdate` on
the device, so the port segments it in time order; the flat fact's codes
are gathered on the device, and the dimension tables are handed to the
port encoded, with their dictionaries, as the fact is.
"""

from __future__ import annotations

import numpy as np
import torch

from .star import Star, attr_dict, narrow

MS_DAY = 86_400_000

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS_BY_REGION = {
    "AFRICA": ["ALGERIA", "ETHIOPIA", "KENYA", "MOROCCO", "MOZAMBIQUE"],
    "AMERICA": ["ARGENTINA", "BRAZIL", "CANADA", "PERU", "UNITED STATES"],
    "ASIA": ["CHINA", "INDIA", "INDONESIA", "JAPAN", "VIETNAM"],
    "EUROPE": ["FRANCE", "GERMANY", "ROMANIA", "RUSSIA", "UNITED KINGDOM"],
    "MIDDLE EAST": ["EGYPT", "IRAN", "IRAQ", "JORDAN", "SAUDI ARABIA"],
}
NATIONS = [n for r in REGIONS for n in NATIONS_BY_REGION[r]]  # id = region * 5 + j
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
SHIPMODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
BRANDS = [f"Brand#{a}{b}" for a in range(1, 6) for b in range(1, 6)]
# TPC-H's 150 part types: three syllables (specification, clause 4.2.2.13)
TYPES = [f"{a} {b} {c}" for a in ("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO")
         for b in ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED")
         for c in ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER")]
RETURNFLAGS = ["A", "N", "R"]
LINESTATUS = ["F", "O"]
LINESTATUS_CUT = "1995-06-17"  # shipped before: F, else O

# flat attribute -> the table it comes from, as the port's flat datasource
# carries them (customer attributes ride the orders row: a snowflake edge)
DIM_ATTRS = {
    "o_orderpriority": "orders",
    "o_orderdate": "orders",
    "o_orderdate_year": "orders",
    "c_custkey": "customer",
    "c_name": "customer",
    "c_mktsegment": "customer",
    "c_nation": "customer",
    "c_region": "customer",
    "s_nation": "supplier",
    "s_region": "supplier",
    "p_brand": "part",
    "p_type": "part",
    "l_returnflag": "lineitem",
    "l_linestatus": "lineitem",
    "l_shipmode": "lineitem",
    "l_orderkey": "lineitem",
}
FLAT_METRICS = ["l_quantity", "l_extendedprice", "l_discount", "l_tax"]


def ms(day: str) -> int:
    return int(np.datetime64(day, "ms").astype(np.int64))


def _year(ms_values: torch.Tensor) -> torch.Tensor:
    days = ms_values.cpu().numpy().astype("datetime64[ms]")
    return torch.as_tensor(days.astype("datetime64[Y]").astype(np.int64) + 1970,
                           device=ms_values.device)


def generate(scale: float, seed: int, device) -> Star:
    """The normalized subset at SF `scale` (SF1: 6001215 lineitem rows),
    drawn from `seed`.  Keys are dense 0..n-1."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))

    def ints(lo, hi, n, dtype=torch.int64):
        return torch.randint(lo, hi, (n,), generator=g, device=device, dtype=dtype)

    n_c = max(100, int(150_000 * scale))
    c_region = ints(0, 5, n_c)
    customer = {"c_custkey": torch.arange(n_c, device=device),
                "c_name": torch.arange(n_c, device=device),  # id k: Customer#k
                "c_mktsegment": ints(0, 5, n_c),
                "c_nation": c_region * 5 + ints(0, 5, n_c),
                "c_region": c_region}
    n_s = max(50, int(10_000 * scale))
    s_region = ints(0, 5, n_s)
    supplier = {"s_suppkey": torch.arange(n_s, device=device),
                "s_nation": s_region * 5 + ints(0, 5, n_s), "s_region": s_region}
    n_p = max(200, int(200_000 * scale))
    part = {"p_partkey": torch.arange(n_p, device=device),
            "p_brand": ints(0, 5, n_p) * 5 + ints(0, 5, n_p),
            "p_type": ints(0, len(TYPES), n_p)}
    n_o = max(500, int(1_500_000 * scale))
    d0, d1 = ms("1992-01-01") // MS_DAY, ms("1998-08-02") // MS_DAY
    o_orderdate = ints(d0, d1, n_o) * MS_DAY
    orders = {"o_orderkey": torch.arange(n_o, device=device),
              "o_custkey": ints(0, n_c, n_o),
              "o_orderdate": o_orderdate,
              "o_orderpriority": ints(0, 5, n_o)}

    n = int(6_001_215 * scale)
    okey = ints(0, n_o, n, torch.int32)
    shipdate = o_orderdate[okey.long()] + ints(1, 122, n) * MS_DAY
    # lineitem in l_shipdate order (the draws are i.i.d., so a stable sort
    # only places them)
    order = torch.sort(shipdate, stable=True).indices
    shipdate = shipdate[order]
    okey = okey[order]
    u = torch.rand(n, generator=g, device=device)
    lineitem = {
        "l_orderkey": okey,
        "l_suppkey": ints(0, n_s, n, torch.int32),
        "l_partkey": ints(0, n_p, n, torch.int32),
        "l_shipdate": shipdate,
        "l_quantity": ints(1, 51, n).to(torch.float32),
        "l_extendedprice": torch.rand(n, generator=g, device=device) * 55_450 + 90,
        "l_discount": (ints(0, 11, n) / 100).to(torch.float32),
        "l_tax": (ints(0, 9, n) / 100).to(torch.float32),
        # A, N, R with probabilities 0.25, 0.5, 0.25
        "l_returnflag": (u >= 0.25).long() + (u >= 0.75).long(),
        "l_linestatus": (shipdate >= ms(LINESTATUS_CUT)).long(),
        "l_shipmode": ints(0, 7, n),
    }
    return Star(
        tables={"lineitem": lineitem, "orders": orders, "customer": customer,
                "supplier": supplier, "part": part},
        names={"c_name": [f"Customer#{k:09d}" for k in range(n_c)],
               "c_mktsegment": SEGMENTS, "c_nation": NATIONS, "c_region": REGIONS,
               "s_nation": NATIONS, "s_region": REGIONS, "p_brand": BRANDS, "p_type": TYPES,
               "o_orderpriority": PRIORITIES, "l_returnflag": RETURNFLAGS,
               "l_linestatus": LINESTATUS, "l_shipmode": SHIPMODES},
    )


def register(ctx, star: Star, cfg: dict) -> None:
    """Hand the port the flat lineitem fact (16 attributes as dictionary
    codes, 4 metrics, `l_shipdate` as its time column) with the snowflake
    declared in `cfg`, in `cfg["rows_per_segment"]`-row segments, and the
    orders, customer, supplier and part tables."""
    t = star.tables
    li, o = t["lineitem"], t["orders"]
    okey = li["l_orderkey"].long()
    rows = {"orders": okey, "customer": o["o_custkey"][okey],
            "supplier": li["l_suppkey"].long(), "part": li["l_partkey"].long(), "lineitem": None}
    o_year = _year(o["o_orderdate"])
    source = {**t, "orders": {**o, "o_orderdate_year": o_year}}
    cols = {"l_shipdate": li["l_shipdate"].cpu().numpy()}
    dicts = {}
    dim_codes = {}
    for attr, table in DIM_ATTRS.items():
        d, codes = attr_dict(source[table][attr], star.names.get(attr))
        dicts[attr] = d
        dim_codes[attr] = codes
        fact_codes = codes if rows[table] is None else codes[rows[table]]
        cols[attr] = narrow(fact_codes, d.cardinality).cpu().numpy()
    for m in FLAT_METRICS:
        cols[m] = li[m].cpu().numpy()
    ctx.register_table(
        "lineitem", cols, dimensions=list(DIM_ATTRS), metrics=FLAT_METRICS,
        time_column="l_shipdate", star_schema=cfg["star_schema"],
        rows_per_segment=int(cfg["rows_per_segment"]), dicts=dicts,
    )
    del cols
    ctx.register_table(
        "orders",
        {"o_orderkey": o["o_orderkey"].cpu().numpy(), "o_custkey": o["o_custkey"].cpu().numpy(),
         "o_orderdate": o["o_orderdate"].cpu().numpy(),
         "o_orderpriority": dim_codes["o_orderpriority"].cpu().numpy()},
        dimensions=["o_orderpriority"], metrics=["o_orderkey", "o_custkey"],
        time_column="o_orderdate", dicts={"o_orderpriority": dicts["o_orderpriority"]},
    )
    for table, key, attrs in (
            ("customer", "c_custkey", ("c_name", "c_mktsegment", "c_nation", "c_region")),
            ("supplier", "s_suppkey", ("s_nation", "s_region")),
            ("part", "p_partkey", ("p_brand", "p_type"))):
        ctx.register_table(
            table,
            {key: t[table][key].cpu().numpy(),
             **{a: dim_codes[a].cpu().numpy() for a in attrs}},
            dimensions=list(attrs), metrics=[key], dicts={a: dicts[a] for a in attrs},
        )
