"""The Star Schema Benchmark's star, drawn from a seed on the device.

Frozen copy of the value distributions of
spark_druid_olap_tpu_torch/workloads/ssb.py (`gen_dim_tables`, `_geo`,
`_gen_fact`) and of its flat layout (`DIM_ATTRS`, `FLAT_METRICS`,
`flat_columns`, `register`).  Changed here: brands are worded as SSB's
(`MFGR#2221`, not `MFGR#22-21`), and the part table has SSB's
200,000 x floor(1 + log2 SF) rows (not 200,000 x SF); every table is drawn with one
`torch.Generator` on the device in a few large calls instead of numpy on
the host; string attributes are held as ids into fixed name lists, so no
per-row string is ever made; the flat fact's dictionary codes are gathered
on the device; the four dimension tables are handed to the port encoded,
with their dictionaries, as the fact is.

`generate(scale, seed, device)` returns the normalized star (`Star`), which
the reference reads; `register(ctx, star, cfg)` hands the port what a user
registers: the flat fact and the four dimension tables.
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
CITIES = [f"{n}{d}" for n in NATIONS for d in range(10)]  # id = nation * 10 + digit
MFGRS = [f"MFGR#{m}" for m in range(1, 6)]
CATEGORIES = [f"MFGR#{m}{c}" for m in range(1, 6) for c in range(1, 6)]
BRANDS = [f"{c}{b}" for c in CATEGORIES for b in range(1, 41)]  # SSB's: MFGR#2221

# flat attribute -> (dimension table, fact foreign key), as the port's flat
# datasource carries them
DIM_ATTRS = {
    "d_year": ("dwdate", "lo_orderdate"),
    "d_yearmonthnum": ("dwdate", "lo_orderdate"),
    "d_yearmonth": ("dwdate", "lo_orderdate"),
    "d_weeknuminyear": ("dwdate", "lo_orderdate"),
    "c_region": ("customer", "lo_custkey"),
    "c_nation": ("customer", "lo_custkey"),
    "c_city": ("customer", "lo_custkey"),
    "s_region": ("supplier", "lo_suppkey"),
    "s_nation": ("supplier", "lo_suppkey"),
    "s_city": ("supplier", "lo_suppkey"),
    "p_mfgr": ("part", "lo_partkey"),
    "p_category": ("part", "lo_partkey"),
    "p_brand1": ("part", "lo_partkey"),
}
FLAT_METRICS = ["lo_quantity", "lo_extendedprice", "lo_discount", "lo_revenue",
                "lo_supplycost", "lo_custkey"]


def _dwdate():
    """One row a calendar day, 1992-01-01 .. 1998-12-31 (host numpy: 2557 rows)."""
    days = np.arange(np.datetime64("1992-01-01"), np.datetime64("1999-01-01"),
                     dtype="datetime64[D]")
    years = days.astype("datetime64[Y]").astype(np.int64) + 1970
    month_idx = days.astype("datetime64[M]").astype(np.int64) - (1992 - 1970) * 12
    months = month_idx % 12 + 1
    day_of_year = (days - days.astype("datetime64[Y]")).astype(np.int64) + 1
    names = [f"{1992 + i // 12}-{i % 12 + 1:02d}" for i in range(7 * 12)]
    cols = {
        "d_datekey": days.astype("datetime64[ms]").astype(np.int64),
        "d_year": years,
        "d_yearmonthnum": years * 100 + months,
        "d_yearmonth": month_idx,  # id into `names`
        "d_weeknuminyear": (day_of_year - 1) // 7 + 1,
    }
    return cols, names


def _geo(n, g, device):
    region = torch.randint(0, 5, (n,), generator=g, device=device)
    nation = region * 5 + torch.randint(0, 5, (n,), generator=g, device=device)
    city = nation * 10 + torch.randint(0, 10, (n,), generator=g, device=device)
    return region, nation, city


def generate(scale: float, seed: int, device) -> Star:
    """The normalized star at SF `scale` (SF1: 6M lineorder rows), drawn
    from `seed`.  Keys are dense 0..n-1."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    dw, ym_names = _dwdate()
    dwdate = {k: torch.as_tensor(v, device=device) for k, v in dw.items()}

    n_c = max(100, int(30_000 * scale))
    c_region, c_nation, c_city = _geo(n_c, g, device)
    n_s = max(50, int(2_000 * scale))
    s_region, s_nation, s_city = _geo(n_s, g, device)
    # SSB: 200,000 x floor(1 + log2 SF) parts (SF10: 800,000); below SF1, x SF
    n_p = max(200, int(200_000 * (1 + int(np.log2(scale)) if scale >= 1 else scale)))
    mfgr = torch.randint(0, 5, (n_p,), generator=g, device=device)
    category = mfgr * 5 + torch.randint(0, 5, (n_p,), generator=g, device=device)
    brand = category * 40 + torch.randint(0, 40, (n_p,), generator=g, device=device)

    n = int(6_000_000 * scale)
    n_days = dwdate["d_datekey"].shape[0]
    # dates drawn sorted: the fact arrives time-sorted, as Druid segments it
    date_idx = torch.sort(torch.randint(0, n_days, (n,), generator=g, device=device,
                                        dtype=torch.int32)).values
    custkey = torch.randint(0, n_c, (n,), generator=g, device=device, dtype=torch.int32)
    suppkey = torch.randint(0, n_s, (n,), generator=g, device=device, dtype=torch.int32)
    partkey = torch.randint(0, n_p, (n,), generator=g, device=device, dtype=torch.int32)
    quantity = torch.randint(1, 51, (n,), generator=g, device=device).to(torch.float32)
    extendedprice = torch.rand(n, generator=g, device=device, dtype=torch.float32) * 55_450 + 90
    discount = torch.randint(0, 11, (n,), generator=g, device=device).to(torch.float32)
    lineorder = {
        "lo_orderdate": date_idx,  # row of dwdate; the port gets d_datekey
        "lo_custkey": custkey,
        "lo_suppkey": suppkey,
        "lo_partkey": partkey,
        "lo_quantity": quantity,
        "lo_extendedprice": extendedprice,
        "lo_discount": discount,
        "lo_revenue": extendedprice * (1 - discount / 100),
        "lo_supplycost": extendedprice * 0.6,
    }
    return Star(
        tables={
            "lineorder": lineorder,
            "dwdate": dwdate,
            "customer": {"c_custkey": torch.arange(n_c, device=device),
                         "c_region": c_region, "c_nation": c_nation, "c_city": c_city},
            "supplier": {"s_suppkey": torch.arange(n_s, device=device),
                         "s_region": s_region, "s_nation": s_nation, "s_city": s_city},
            "part": {"p_partkey": torch.arange(n_p, device=device),
                     "p_mfgr": mfgr, "p_category": category, "p_brand1": brand},
        },
        names={
            "d_yearmonth": ym_names,
            "c_region": REGIONS, "c_nation": NATIONS, "c_city": CITIES,
            "s_region": REGIONS, "s_nation": NATIONS, "s_city": CITIES,
            "p_mfgr": MFGRS, "p_category": CATEGORIES, "p_brand1": BRANDS,
        },
    )


def register(ctx, star: Star, cfg: dict) -> None:
    """Hand the port the flat fact (13 attributes gathered through the
    foreign keys as dictionary codes, 6 metrics, the time column) with the
    star declared in `cfg`, time-sorted into `cfg["rows_per_segment"]`-row
    segments, and the four dimension tables."""
    t = star.tables
    fact = t["lineorder"]
    cols = {"lo_orderdate": t["dwdate"]["d_datekey"][fact["lo_orderdate"].long()].cpu().numpy()}
    dicts = {}
    dim_codes = {}
    for attr, (table, fk) in DIM_ATTRS.items():
        d, codes = attr_dict(t[table][attr], star.names.get(attr))
        dicts[attr] = d
        dim_codes[attr] = codes
        # every foreign key is the row of its dimension table
        cols[attr] = narrow(codes[fact[fk].long()], d.cardinality).cpu().numpy()
    for m in FLAT_METRICS:
        cols[m] = fact[m].cpu().numpy()
    ctx.register_table(
        "lineorder", cols, dimensions=list(DIM_ATTRS), metrics=FLAT_METRICS,
        time_column="lo_orderdate", star_schema=cfg["star_schema"],
        rows_per_segment=int(cfg["rows_per_segment"]), dicts=dicts,
    )
    del cols
    dw = t["dwdate"]
    ctx.register_table(
        "dwdate",
        {"d_datekey": dw["d_datekey"].cpu().numpy(),
         "d_year": dw["d_year"].cpu().numpy(),
         "d_yearmonthnum": dw["d_yearmonthnum"].cpu().numpy(),
         "d_yearmonth": dim_codes["d_yearmonth"].cpu().numpy(),
         "d_weeknuminyear": dw["d_weeknuminyear"].cpu().numpy()},
        dimensions=["d_yearmonth"], metrics=["d_year", "d_yearmonthnum", "d_weeknuminyear"],
        time_column="d_datekey", dicts={"d_yearmonth": dicts["d_yearmonth"]},
    )
    for table, key, attrs in (("customer", "c_custkey", ("c_region", "c_nation", "c_city")),
                              ("supplier", "s_suppkey", ("s_region", "s_nation", "s_city")),
                              ("part", "p_partkey", ("p_mfgr", "p_category", "p_brand1"))):
        ctx.register_table(
            table,
            {key: t[table][key].cpu().numpy(),
             **{a: dim_codes[a].cpu().numpy() for a in attrs}},
            dimensions=list(attrs), metrics=[key], dicts={a: dicts[a] for a in attrs},
        )
