"""Per-iteration records of the optimizer loops.

Port of auto_oo_tpu/utils/observe.py (pure Python): a structured
record stream with pluggable sinks (stdout, a JSONL file, memory)
carrying the physics diagnostics (energy, lowest Hessian eigenvalue,
wall time), in place of the reference's print + verbose flags
(SURVEY.md section 5).  ``OO_pqc.full_optimization(monitor=)`` and
``gradient_optimization(monitor=)`` call ``log`` once per iteration.
"""

import json
import time


class Monitor:
    """Collects per-iteration records; optionally tees to stdout/JSONL."""

    def __init__(self, stdout=False, jsonl_path=None, label=""):
        self.records = []
        self.stdout = stdout
        self.label = label
        self._fh = open(jsonl_path, "a") if jsonl_path else None
        self._t0 = time.time()

    def log(self, iteration, energy, **metrics):
        rec = {"label": self.label, "iter": int(iteration),
               "energy": float(energy),
               "wall_s": round(time.time() - self._t0, 6)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self.records.append(rec)
        if self.stdout:
            shown = {k: v for k, v in rec.items() if k != "label"}
            print(" ".join(f"{k}={v}" for k, v in shown.items()),
                  flush=True)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def energies(self):
        return [r["energy"] for r in self.records]
