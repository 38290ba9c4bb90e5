"""The control (the reference in float8 e4m3 in the program's place) and the
planted faults read far above a sound run, at a tiny size on the CPU; on the
card, `perfbench/control.py` reads them at each cell's own size."""
import pytest
import torch

from perfbench import control
from perfbench.tests import tiny


@pytest.mark.parametrize("name", ["serve-512-bf16", "vae-stage1-512", "lora-512-b8"])
def test_control_reads_far_above_the_program(name):
    record = tiny.run(name)
    kind = record.traffic["driver"]
    got = control.control_readings(kind, record, 2**33 + 5, torch.device("cpu"))
    sound = {c.name: c.value for c in record.checks}
    fp8 = got["fp8_reference"]
    first = "image_rms" if kind == "serve" else "grad_gap"
    assert fp8[first] > 3 * max(sound[first], 1e-7), (fp8, sound)
    if kind != "serve":
        assert got["half_batch"]["grad_gap"] > 10 * max(sound["grad_gap"], 1e-7)
