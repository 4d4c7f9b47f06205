"""``correct`` at the small cells on the CPU: the port agrees with the
plain reference, the control (the reference in float8 put in the
program's place) does not, and neither does a run with a fault planted
underneath the timed path."""
import pytest

from portbench.tests import smoke


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke.tree(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", sorted(smoke.CELLS))
def test_port_agrees_with_the_reference_and_the_control_does_not(root, cell):
    ctx, res = smoke.run(root, cell, control=True)
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert smoke.correct(ctx, res["readings"]), res["readings"]
    assert not smoke.correct(ctx, ctx.control), ctx.control
    # and parts from the reference by three times the port or more, as a
    # control has to where it sets a limit's upper reading
    ratio = max(ctx.control[k] / max(v, 1e-6)
                for k, v in res["readings"].items())
    assert ratio >= 3, (res["readings"], ctx.control)


@pytest.mark.parametrize("cell,fault", [
    ("t-smoke", "state_unchanged"), ("t-smoke", "half_batch"),
    ("g-smoke", "half_batch"), ("p-smoke", "token"),
    ("p-smoke", "unshipped")])
def test_a_planted_fault_is_not_correct(root, cell, fault):
    ctx, res = smoke.run(root, cell, fault=fault)
    assert not smoke.correct(ctx, res["readings"]), res["readings"]


@pytest.mark.card
def test_the_small_cells_on_the_card(root, card):
    for cell in sorted(smoke.CELLS):
        ctx, res = smoke.run(root, cell, device=card, control=True)
        assert smoke.correct(ctx, res["readings"]), (cell, res["readings"])
