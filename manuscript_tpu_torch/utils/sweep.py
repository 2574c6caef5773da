"""Hyperparameter search: an Optuna-equivalent TPE workflow without the
optuna dependency (reference: src/example3_optuna.py:321-405 — TPE sampler,
sqlite storage, resumable study, best-trial reporting).

The port's own copy of ``manuscript_tpu/utils/sweep.py`` (numpy and sqlite3
only, no device code): the same seed and objective give the same trials in
both packages, and each reads the other's storage.

Two samplers:

* ``sampler="tpe"`` (default) — Tree-structured Parzen Estimator in the
  Bergstra et al. form: after ``n_warmup`` uniform trials, split history
  into good (top ``gamma`` quantile) and bad sets, model each with a
  Parzen mixture (per-observation Gaussians for float/int, weighted
  counts for categorical), draw ``n_ei_candidates`` from the good model
  and keep the candidate maximizing l(x)/g(x) — the EI surrogate.
* ``sampler="guided"`` — the simpler top-quantile perturbation sampler
  (kept for reproducibility of earlier sweeps).

Storage: ``.json`` (append-on-tell snapshot) or ``.db``/``.sqlite``
(stdlib sqlite3, one row per trial — the Optuna storage analog; safe to
resume and to read concurrently).

Param specs: ``("float", lo, hi)``, ``("float", lo, hi, "log")``,
``("int", lo, hi)``, ``("cat", [choices])``.
"""

from __future__ import annotations

import json
import sqlite3
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

ParamSpec = Tuple  # ("float", lo, hi[, "log"]) | ("int", lo, hi) | ("cat", [..])


# --------------------------------------------------------------------------
# storage backends


class _JsonStorage:
    def __init__(self, path: Path):
        self.path = path

    def load(self) -> Tuple[List[Dict[str, Any]], Optional[str]]:
        if not self.path.exists():
            return [], None
        data = json.loads(self.path.read_text())
        return data["trials"], data.get("direction")

    def append(self, trial: Dict[str, Any], direction: str,
               trials: List[Dict[str, Any]]) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(
            json.dumps({"direction": direction, "trials": trials}, indent=1)
        )


class _SqliteStorage:
    """One row per trial; params as a JSON column. Resumable and safe for
    concurrent readers (sqlite serializes writers)."""

    def __init__(self, path: Path):
        self.path = path
        path.parent.mkdir(parents=True, exist_ok=True)
        with self._conn() as c:
            c.execute(
                "CREATE TABLE IF NOT EXISTS trials ("
                "number INTEGER PRIMARY KEY, params TEXT NOT NULL, "
                "value REAL NOT NULL, datetime REAL NOT NULL)"
            )
            c.execute(
                "CREATE TABLE IF NOT EXISTS study_meta ("
                "key TEXT PRIMARY KEY, value TEXT NOT NULL)"
            )

    def _conn(self):
        return sqlite3.connect(self.path, timeout=30.0)

    def load(self) -> Tuple[List[Dict[str, Any]], Optional[str]]:
        with self._conn() as c:
            rows = c.execute(
                "SELECT number, params, value, datetime FROM trials "
                "ORDER BY number"
            ).fetchall()
            meta = c.execute(
                "SELECT value FROM study_meta WHERE key='direction'"
            ).fetchone()
        trials = [
            {"number": n, "params": json.loads(p), "value": v, "datetime": d}
            for n, p, v, d in rows
        ]
        return trials, (meta[0] if meta else None)

    def append(self, trial: Dict[str, Any], direction: str,
               trials: List[Dict[str, Any]]) -> None:
        with self._conn() as c:
            c.execute(
                "INSERT OR REPLACE INTO study_meta (key, value) "
                "VALUES ('direction', ?)",
                (direction,),
            )
            c.execute(
                "INSERT INTO trials (number, params, value, datetime) "
                "VALUES (?, ?, ?, ?)",
                (
                    trial["number"],
                    json.dumps(trial["params"]),
                    trial["value"],
                    trial["datetime"],
                ),
            )


def _make_storage(storage: Union[str, Path]) -> Union[_JsonStorage, _SqliteStorage]:
    path = Path(storage)
    if path.suffix in (".db", ".sqlite", ".sqlite3"):
        return _SqliteStorage(path)
    return _JsonStorage(path)


# --------------------------------------------------------------------------
# TPE internals


def _to_internal(spec: ParamSpec, v):
    """Map a param value onto the real line the Parzen mixture lives on."""
    if spec[0] == "float" and len(spec) > 3 and spec[3] == "log":
        return np.log(v)
    return float(v)


def _from_internal(spec: ParamSpec, x: float):
    if spec[0] == "float":
        lo, hi = spec[1], spec[2]
        if len(spec) > 3 and spec[3] == "log":
            return float(np.clip(np.exp(x), lo, hi))
        return float(np.clip(x, lo, hi))
    lo, hi = spec[1], spec[2]
    return int(np.clip(round(x), lo, hi))


def _parzen_logpdf(xs: np.ndarray, obs: np.ndarray, lo: float, hi: float):
    """log density of a uniform-weighted Gaussian mixture centered at the
    observations, plus one wide prior component spanning the range."""
    width = max(hi - lo, 1e-12)
    sigma = max(width / max(len(obs), 1) ** 0.5 * 0.5, width * 0.02)
    centers = np.concatenate([obs, [(lo + hi) / 2.0]])
    sigmas = np.full(len(centers), sigma)
    sigmas[-1] = width  # prior component
    d = xs[:, None] - centers[None, :]
    comp = -0.5 * (d / sigmas) ** 2 - np.log(sigmas * np.sqrt(2 * np.pi))
    m = comp.max(axis=1, keepdims=True)
    return (m[:, 0] + np.log(np.exp(comp - m).mean(axis=1)))


class Study:
    def __init__(
        self,
        space: Dict[str, ParamSpec],
        storage: Optional[Union[str, Path]] = None,
        direction: str = "maximize",
        seed: int = 0,
        n_warmup: int = 10,
        top_quantile: float = 0.25,
        sampler: str = "tpe",
        n_ei_candidates: int = 24,
    ):
        if sampler not in ("tpe", "guided"):
            raise ValueError(f"unknown sampler {sampler!r}")
        self.space = space
        self.direction = direction
        self.storage = _make_storage(storage) if storage else None
        self.rng = np.random.default_rng(seed)
        self.n_warmup = n_warmup
        self.top_quantile = top_quantile
        self.sampler = sampler
        self.n_ei_candidates = n_ei_candidates
        self.trials: List[Dict[str, Any]] = []
        if self.storage:
            self.trials, stored_dir = self.storage.load()
            # a resumed study keeps its recorded direction (Optuna refuses a
            # conflicting reopen; here the stored one simply wins so a bare
            # Study(space, storage=...) reads back correctly)
            if stored_dir is not None:
                self.direction = stored_dir

    # -- sampling ----------------------------------------------------------

    def _sample_uniform(self) -> Dict[str, Any]:
        params = {}
        for name, spec in self.space.items():
            kind = spec[0]
            if kind == "float":
                lo, hi = spec[1], spec[2]
                if len(spec) > 3 and spec[3] == "log":
                    params[name] = float(
                        np.exp(self.rng.uniform(np.log(lo), np.log(hi)))
                    )
                else:
                    params[name] = float(self.rng.uniform(lo, hi))
            elif kind == "int":
                params[name] = int(self.rng.integers(spec[1], spec[2] + 1))
            elif kind == "cat":
                params[name] = spec[1][int(self.rng.integers(len(spec[1])))]
            else:
                raise ValueError(f"unknown spec {spec}")
        return params

    def _split_good_bad(self):
        scores = np.array([t["value"] for t in self.trials], dtype=float)
        if self.direction == "minimize":
            scores = -scores
        order = np.argsort(-scores)
        k = max(1, int(np.ceil(len(scores) * self.top_quantile)))
        return order[:k], order[k:]

    def _sample_tpe(self) -> Dict[str, Any]:
        good_idx, bad_idx = self._split_good_bad()
        params = {}
        for name, spec in self.space.items():
            kind = spec[0]
            good_vals = [self.trials[i]["params"][name] for i in good_idx]
            bad_vals = [self.trials[i]["params"][name] for i in bad_idx]
            if kind == "cat":
                choices = spec[1]
                # weighted counts with add-one smoothing per model
                def probs(vals):
                    w = np.ones(len(choices))
                    for v in vals:
                        w[choices.index(v)] += 1
                    return w / w.sum()

                pg, pb = probs(good_vals), probs(bad_vals)
                cand = self.rng.choice(
                    len(choices), size=self.n_ei_candidates, p=pg
                )
                ratio = np.log(pg[cand]) - np.log(pb[cand])
                params[name] = choices[int(cand[int(np.argmax(ratio))])]
                continue
            if kind == "float" and len(spec) > 3 and spec[3] == "log":
                lo, hi = np.log(spec[1]), np.log(spec[2])
            else:
                lo, hi = float(spec[1]), float(spec[2])
            g_obs = np.array([_to_internal(spec, v) for v in good_vals])
            b_obs = np.array(
                [_to_internal(spec, v) for v in bad_vals]
                or [(lo + hi) / 2.0]
            )
            # draw candidates from the good mixture (incl. its prior comp)
            width = max(hi - lo, 1e-12)
            sigma = max(width / max(len(g_obs), 1) ** 0.5 * 0.5, width * 0.02)
            centers = np.concatenate([g_obs, [(lo + hi) / 2.0]])
            pick = self.rng.integers(len(centers), size=self.n_ei_candidates)
            scale = np.where(pick == len(centers) - 1, width, sigma)
            cand = np.clip(
                centers[pick] + self.rng.normal(size=self.n_ei_candidates) * scale,
                lo, hi,
            )
            lg = _parzen_logpdf(cand, g_obs, lo, hi)
            lb = _parzen_logpdf(cand, b_obs, lo, hi)
            best = cand[int(np.argmax(lg - lb))]
            params[name] = _from_internal(spec, best)
        return params

    def _sample_guided(self) -> Dict[str, Any]:
        good_idx, _ = self._split_good_bad()
        params = {}
        for name, spec in self.space.items():
            kind = spec[0]
            anchor_trial = self.trials[int(self.rng.choice(good_idx))]
            anchor = anchor_trial["params"][name]
            if kind == "float":
                lo, hi = spec[1], spec[2]
                sigma = (hi - lo) * 0.15
                params[name] = float(np.clip(self.rng.normal(anchor, sigma), lo, hi))
            elif kind == "int":
                lo, hi = spec[1], spec[2]
                sigma = max(1.0, (hi - lo) * 0.15)
                params[name] = int(np.clip(round(self.rng.normal(anchor, sigma)), lo, hi))
            else:
                if self.rng.uniform() < 0.7:
                    params[name] = anchor
                else:
                    params[name] = spec[1][int(self.rng.integers(len(spec[1])))]
        return params

    def ask(self) -> Dict[str, Any]:
        if len(self.trials) < self.n_warmup:
            return self._sample_uniform()
        return (
            self._sample_tpe() if self.sampler == "tpe" else self._sample_guided()
        )

    def tell(self, params: Dict[str, Any], value: float) -> None:
        trial = {
            "number": len(self.trials),
            "params": params,
            "value": float(value),
            "datetime": time.time(),
        }
        self.trials.append(trial)
        if self.storage:
            self.storage.append(trial, self.direction, self.trials)

    # -- driving -----------------------------------------------------------

    def optimize(self, objective: Callable[[Dict[str, Any]], float], n_trials: int):
        for _ in range(n_trials):
            params = self.ask()
            value = objective(params)
            self.tell(params, value)
        return self.best_trial

    @property
    def best_trial(self) -> Optional[Dict[str, Any]]:
        if not self.trials:
            return None
        key = (lambda t: t["value"]) if self.direction == "maximize" else (
            lambda t: -t["value"]
        )
        return max(self.trials, key=key)

    def summary(self, top: int = 5) -> str:
        """Plain-text leaderboard (the dashboard the reference auto-launched
        via optuna-dashboard, minus the web server)."""
        if not self.trials:
            return "no trials"
        rev = self.direction == "maximize"
        ranked = sorted(self.trials, key=lambda t: t["value"], reverse=rev)
        lines = [f"{len(self.trials)} trials ({self.direction}); top {top}:"]
        for t in ranked[:top]:
            lines.append(
                f"  #{t.get('number', '?'):>3}  value={t['value']:.6g}  "
                f"{t['params']}"
            )
        return "\n".join(lines)


# --------------------------------------------------------------------------
# reporting (the optuna-dashboard analog — reference example3_optuna.py:
# 377-405 auto-launches optuna-dashboard over the sqlite storage; here the
# same storage renders to a dependency-free self-contained HTML report)


def load_study(storage: Union[str, Path]):
    """Read a study's (trials, direction) from json/sqlite storage."""
    trials, direction = _make_storage(storage).load()
    return trials, (direction or "maximize")


def _svg_scatter(points, w=640, h=240, best_line=None, title=""):
    """Tiny inline-SVG scatter (x, y) with an optional running-best line."""
    if not points:
        return f"<p>(no data for {title})</p>"
    xs = [p[0] for p in points]
    ys = [p[1] for p in points]
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    xr = (x1 - x0) or 1.0
    yr = (y1 - y0) or 1.0
    pad = 30

    def sx(x):
        return pad + (x - x0) / xr * (w - 2 * pad)

    def sy(y):
        return h - pad - (y - y0) / yr * (h - 2 * pad)

    dots = "".join(
        f'<circle cx="{sx(x):.1f}" cy="{sy(y):.1f}" r="3" '
        'fill="#2b6cb0" fill-opacity="0.75"/>'
        for x, y in points
    )
    line = ""
    if best_line:
        pts = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in best_line)
        line = (
            f'<polyline points="{pts}" fill="none" stroke="#c05621" '
            'stroke-width="2"/>'
        )
    return (
        f"<h3>{title}</h3>"
        f'<svg width="{w}" height="{h}" '
        'style="background:#f7fafc;border:1px solid #cbd5e0">'
        f'<text x="{pad}" y="14" font-size="11">'
        f"y: [{y0:.4g}, {y1:.4g}]  x: [{x0:.4g}, {x1:.4g}]</text>"
        f"{dots}{line}</svg>"
    )


def sweep_report(
    storage: Union[str, Path], out_html: Optional[Union[str, Path]] = None
) -> str:
    """Text summary of a study + optional self-contained HTML report
    (trial-history scatter with running best, best-trial table, one
    value-vs-param scatter per numeric parameter, category means for
    categoricals). Returns the text summary."""
    trials, direction = load_study(storage)
    lines = [f"study: {storage} ({len(trials)} trials, {direction})"]
    if not trials:
        summary = lines[0]
        if out_html:
            Path(out_html).parent.mkdir(parents=True, exist_ok=True)
            Path(out_html).write_text(f"<html><body><p>{summary}</p></body></html>")
        return summary
    sign = 1.0 if direction == "maximize" else -1.0
    best = max(trials, key=lambda t: sign * t["value"])
    lines.append(f"best: value={best['value']:.6g} params={best['params']}")
    values = [t["value"] for t in trials]
    lines.append(
        f"values: min={min(values):.6g} max={max(values):.6g} "
        f"mean={float(np.mean(values)):.6g}"
    )
    param_names = sorted({k for t in trials for k in t["params"]})
    cat_notes = []
    for name in param_names:
        vals = [t["params"].get(name) for t in trials]
        if all(isinstance(v, (int, float)) and not isinstance(v, bool)
               for v in vals):
            continue
        by_cat: Dict[Any, List[float]] = {}
        for t in trials:
            by_cat.setdefault(t["params"].get(name), []).append(t["value"])
        means = {k: float(np.mean(v)) for k, v in by_cat.items()}
        cat_notes.append(f"{name}: " + ", ".join(
            f"{k}={v:.4g} (n={len(by_cat[k])})" for k, v in sorted(
                means.items(), key=lambda kv: -sign * kv[1]
            )
        ))
    if cat_notes:
        lines.append("categorical means: " + "; ".join(cat_notes))
    summary = "\n".join(lines)

    if out_html:
        history = [(t["number"], t["value"]) for t in trials]
        running, cur = [], None
        for n, v in history:
            cur = v if cur is None else (
                max(cur, v) if direction == "maximize" else min(cur, v)
            )
            running.append((n, cur))
        parts = [
            "<html><head><meta charset='utf-8'>"
            "<title>sweep report</title></head>"
            "<body style='font-family:sans-serif;max-width:720px'>",
            f"<h2>Study: {Path(str(storage)).name}</h2>",
            f"<p>{len(trials)} trials ({direction})</p>",
            "<h3>Best trial</h3><table border='1' cellpadding='4'>",
            f"<tr><th>value</th><td>{best['value']:.6g}</td></tr>",
        ]
        parts.extend(
            f"<tr><th>{k}</th><td>{v}</td></tr>"
            for k, v in best["params"].items()
        )
        parts.append("</table>")
        parts.append(
            _svg_scatter(
                history, best_line=running,
                title="Trial history (orange = running best)",
            )
        )
        for name in param_names:
            pts = [
                (t["params"][name], t["value"])
                for t in trials
                if isinstance(t["params"].get(name), (int, float))
                and not isinstance(t["params"].get(name), bool)
            ]
            if pts:
                parts.append(_svg_scatter(pts, title=f"value vs {name}"))
        if cat_notes:
            parts.append("<h3>Categorical means</h3><ul>")
            parts.extend(f"<li>{n}</li>" for n in cat_notes)
            parts.append("</ul>")
        parts.append("</body></html>")
        Path(out_html).parent.mkdir(parents=True, exist_ok=True)
        Path(out_html).write_text("\n".join(parts))
    return summary
