"""The reference's hardcoded per-variable normalization tables.

The port's copy of `dlwpbench_tpu/data/stats_tables.py`: the same
numbers as the reference's `data/datasets/datasets.py:70-263`, three
tables of z-score statistics computed over different training periods —
`FULL_MANUAL` (1940-start training window), `HALF_MANUAL` (1979-start),
and `HALF_MANUAL_32` (1979-start at the 2.0-degree/hpx32 resolution, the
table the reference actually hardcodes at `datasets.py:264`).

Each entry maps a config variable name to the on-disk directory name
(`file_name`) and its mean/std.  `lsm` keeps mean=0/std=1 on purpose: the
land-sea mask is not normalized (reference comment, `datasets.py:76`).
"""

from __future__ import annotations

from dlwpbench_tpu_torch.data.dataset import VariableStats

FULL_MANUAL = {
    "tisr": {"file_name": "toa_incident_solar_radiation",
             "mean": 0.25008788148804867, "std": 0.32267114861296226},
    "lsm": {"file_name": "lsm", "mean": 0, "std": 1},
    "lat2d": {"file_name": "lat2d", "mean": 0, "std": 51.936146191742026},
    "lon2d": {"file_name": "lon2d", "mean": 177.1875, "std": 103.9103617607503},
    "orography": {"file_name": "orography", "mean": 379.4976, "std": 859.87225},
    "msl": {"file_name": "msl", "mean": 101142.46702547799, "std": 1044.7123165632315},
    "stream250": {"file_name": "stream250",
                  "mean": -18528.25642087052, "std": 66413973.460995585},
    "stream500": {"file_name": "stream500",
                  "mean": -11990.837318404307, "std": 30880461.37769371},
}

HALF_MANUAL = {
    "tisr": {"file_name": "toa_incident_solar_radiation",
             "mean": 0.2500256896018982, "std": 0.3228904902935028},
    "lsm": {"file_name": "lsm", "mean": 0, "std": 1},
    "lat2d": {"file_name": "lat2d", "mean": 0.5, "std": 51.96072},
    "lon2d": {"file_name": "lon2d", "mean": 179.5, "std": 103.922646},
    "orography": {"file_name": "orography",
                  "mean": 370.4871669133824, "std": 840.2511704642723},
    "msl": {"file_name": "msl", "mean": 101155.25, "std": 1093.2652587890625},
    "stream250": {"file_name": "stream250", "mean": -803927.5, "std": 66434284.0},
    "stream500": {"file_name": "stream500", "mean": -368886.46875, "std": 30952428.0},
}

_GEOPOT = {"mean": 2.684756054804893e-06, "std": 5.950411718913529e-07}

HALF_MANUAL_32 = {
    "tisr": {"file_name": "toa_incident_solar_radiation",
             "mean": 0.2508913626665014, "std": 0.3232416586372475},
    "lsm": {"file_name": "lsm", "mean": 0, "std": 1},
    **{f"geopotential-{lv}": {"file_name": f"geopotential-{lv}", **_GEOPOT}
       for lv in (50, 100, 150, 200, 250, 300, 400, 500, 600, 700, 850, 925, 1000)},
    "lat2d": {"file_name": "lat2d", "mean": 0.5, "std": 51.96072},
    "lon2d": {"file_name": "lon2d", "mean": 179.5, "std": 103.922646},
    "orography": {"file_name": "orography",
                  "mean": 370.4871669133824, "std": 840.2511704642723},
    "msl": {"file_name": "msl",
            "mean": 101141.42129534102, "std": 1091.1232502005057},
    "stream250": {"file_name": "stream250",
                  "mean": -749880.9128180227, "std": 66771987.291932374},
    "stream500": {"file_name": "stream500",
                  "mean": -48478.47349296967, "std": 31118257.308523186},
}

TABLES = {
    "full_manual": FULL_MANUAL,
    "half_manual": HALF_MANUAL,
    "half_manual_32": HALF_MANUAL_32,
}


def select_table(name: str | None, train_start_year: int | None = None) -> dict:
    """Reference table choice: explicit name wins; else 1940-start training
    selects FULL_MANUAL, anything later HALF_MANUAL (`datasets.py:245-258`).
    """
    if name:
        return TABLES[name]
    if train_start_year == 1940:
        return FULL_MANUAL
    return HALF_MANUAL


def file_name_for(table: dict, var: str) -> str:
    """Directory name on disk for a config variable (identity if untabled)."""
    entry = table.get(var)
    return entry["file_name"] if entry else var


def stats_for(table: dict, var: str, level=None) -> VariableStats | None:
    """Manual stats for `var` (optionally at a pressure `level`), or None.

    Level lookup tries the flat `f"{var}-{level}"` / `f"{var}{level}"` keys
    the reference's tables use, then the canonical nested
    `table[var]["level"][level]` form (`datasets.py:393`).
    """
    keys = [var] if level is None else [f"{var}-{level}", f"{var}{level}"]
    for k in keys:
        e = table.get(k)
        if e is not None and "mean" in e:
            return VariableStats(float(e["mean"]), float(e["std"]))
    e = table.get(var)
    if e is not None and level is not None:
        lv = e.get("level", {}).get(level) or e.get("level", {}).get(str(level))
        if lv:
            return VariableStats(float(lv["mean"]), float(lv["std"]))
    return None
