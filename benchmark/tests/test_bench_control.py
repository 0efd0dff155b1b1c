"""The control on the card: the reference one precision below the
configuration's (fp8 convolutions, TF32 matmuls), put in the program's
place, reads above each cell's limits on at least one number, so that the
harness judges it not correct, at a size a test run holds (tiny.shrink);
and the program itself reads within them."""

import pytest

from benchmark import harness
from benchmark.tests import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["learned.orbit", "replica_scale.orbit"])
def test_control_fails_and_the_program_passes(cell, cuda):
    r = harness.run(cell, 20261017, 3.0, False, cuda,
                    overrides=tiny.shrink, control=True)
    assert r["correct"], r["checks"]
    assert r["control_correct"] is False, r["control"]
    assert any(row["value"] > row["limit"]
               for row in r["control"].values()), r["control"]
