"""The output check fails its control and every fault the cells can
have, and passes the program (test_rehearsal)."""

import json

import pytest

from benchmark import calibrate, check, traffic
from benchmark.tests.conftest import DATA


def test_bfloat16_control_fails():
    cell, config, spec = traffic.load_cell("tiny", DATA,
                                           DATA + "/BENCHMARK.json")
    tr = traffic.build(config, spec, 4200000001)
    values = calibrate.control_numbers(tr, config, 120000, [40, 41, 47])
    failed = {name for name, *_, ok in check.judge(values, config["limits"])
              if not ok}
    assert {"baseband_max_abs_diff", "spectrum_db_rms", "WFM_audio_err",
            "USB_audio_err"} <= failed


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
def test_fault_is_not_correct(rehearse, fault):
    rc, out, err = rehearse("--trace", "0", fault=fault)
    assert rc == 0, err[-3000:]
    result = json.loads(out[-1])
    assert result["correct"] is False
