"""Structured training metrics (counterpart of multike_tpu/utils/metrics.py):
one record per stream epoch and per evaluation, kept in memory and, when a
path is given, appended to a JSON-lines file."""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional


class MetricsLog:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.records: List[Dict] = []
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def record(self, **fields) -> Dict:
        rec = {"ts": time.time(), **fields}
        self.records.append(rec)
        if self.path:
            with open(self.path, "a", encoding="utf8") as f:
                f.write(json.dumps(rec) + "\n")
        return rec

    def stream_records(self, stream: str) -> List[Dict]:
        return [r for r in self.records if r.get("stream") == stream]

    def throughput(self, stream: str = "rel_view") -> Optional[float]:
        """Mean triples/s over the recorded epochs of a stream."""
        recs = [r for r in self.stream_records(stream)
                if r.get("trained") and r.get("seconds")]
        if not recs:
            return None
        total = sum(r["trained"] for r in recs)
        secs = sum(r["seconds"] for r in recs)
        return total / secs if secs > 0 else None
