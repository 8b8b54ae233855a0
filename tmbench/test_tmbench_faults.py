"""The comparison that decides ``correct`` fails where it must: every cell
(listed in ``BENCHMARK.json`` or kept as files),
cut to the tests' size, runs through the harness with the timed path as
it is (correct), with the reference put in the program's place one
precision below the configuration's (the control: not correct), and with
each fault the cell can have planted underneath (not correct)."""
import pytest
import torch

from tmbench import control, harness, testing

CELLS = sorted(p.stem for p in (harness.ROOT / "tmbench" / "workloads").glob("*.json"))
CASES = [(name, m) for name in CELLS
         for m in ("program", "control")
         + control.faults_for(harness.cell_from_files(name).kind)]


@pytest.mark.parametrize("name, mode", CASES, ids=[f"{c}-{m}" for c, m in CASES])
def test_correct_only_for_the_program_as_it_is(name, mode):
    cell = testing.tiny(harness.cell_from_files(name))
    (_, line), = control.run(name, mode, [2**31 + 97], 0.3,
                             torch.device("cpu"), cell=cell)
    assert line["correct"] is (mode == "program"), line["compared"]
    if mode != "program":
        assert any(c["value"] > c["limit"] for c in line["compared"].values())
