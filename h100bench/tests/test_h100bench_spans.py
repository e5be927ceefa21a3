"""The readers of the program's spans: each returns None where the program
opens no such span (a program older than its spans), the device ms per unit
where it does, and reads a span that a recorded unit of its kind holds
(drive.Setup on the CPU, the port in float32 at test size)."""

import json
import os

import pytest
import torch

from conftest import ROOT, tiny_cell
import drive
import program
from rovr_torch.utils import profiling

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    B = json.load(f)
SPAN_METRICS = [m["name"] for m in B["per_layer"] if m["source"] == "program_span"]
SEED = 2 ** 31 + 77


class _Probe(dict):
    """An empty `range_ms` table that notes each range a reader asks for."""

    def __init__(self):
        super().__init__()
        self.asked = []

    def get(self, key, default=None):
        self.asked.append(key)
        return super().get(key, default)


def _span(metric: str) -> str:
    probe = _Probe()
    assert drive.reader(metric)({"range_ms": probe, "units": 2}) is None
    (span,) = probe.asked
    return span


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_a_span_reader_is_none_without_its_span_and_per_unit_with_it(metric):
    ctx = {"range_ms": {_span(metric): 9.0}, "units": 3}
    assert drive.reader(metric)(ctx) == pytest.approx(3.0)


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_each_span_a_reader_reads_is_in_a_recorded_unit(kind):
    c = tiny_cell(kind, "attention")
    s = drive.Setup(c["config"]["config"], c["mix"], c["work"], "cpu", torch.float32)
    st = s.seed(SEED)
    item = s.pool[0]
    with profiling.recording() as spans:
        if kind == "train":
            program.train_step(st, s.mods, s.cfg, item["video"], item["org"], item["gumbel"])
        else:
            for _ in program.serve(s.cfg, st, s.mods, [item["video"].numpy()]):
                pass
    held = {sp.name for sp in spans}
    read = {_span(m["name"]) for m in B["per_layer"]
            if m["source"] == "program_span" and c["cell"]["name"] in m["workloads"]}
    assert read and read <= held, read - held
