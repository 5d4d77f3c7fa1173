"""Each cell's control, on the card at the cell's own size: the reference
put in the program's place one precision step below the configuration's
(fp8 for the bfloat16 generator, bfloat16 for the float32/TF32 model) has
to come out not correct, while the program on the same seeds is correct.
Needs the card (the ``cuda`` marker); skips here with a reason.

    python -m pytest -p no:cacheprovider benchmark/tests/test_bench_control.py
"""

import pytest

from harness import registry

SEEDS = (101, 102, 103)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["gen_paper_b512", "extract_paper_b64",
                                  "gan_paper_b4"])
def test_control_is_not_correct(cuda, cell):
    import calibrate
    limits = registry.workload(cell)["limits"]
    for seed in SEEDS:
        got, _, _ = calibrate.readings(cell, seed, 1.0, control=True)
        readings = {what: numbers for what, numbers, _ in got}
        assert all(v <= limits[k]
                   for k, v in readings["program"].items()), readings
        assert any(v > limits[k]
                   for k, v in readings["control"].items()), readings
