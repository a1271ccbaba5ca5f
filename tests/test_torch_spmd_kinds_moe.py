"""The port's SPMD train step for the MoE-attention kinds against the
reference's jitted sharded step, on 4 CPU ``gloo`` ranks and 4 forced host
devices; the checks (a) to (e) and their bounds are
``tests/_torch_spmd_kinds.py``'s.

Cases: reduced llama4-scout-17b-a16e (``moe_local`` and ``moe_nope``,
top-1; 4 experts fill every mesh, so its MoE takes the expert-parallel
path in GRID mode) on the (2, 2), (4, 1) and (1, 4) meshes (ROW mode:
``test_torch_spmd_kinds_row.py``). Worst measured, as a fraction of its
tolerance (``worst_fraction``): 1.0 on (2, 2), a bf16 Adafactor momentum
leaf one bf16 step off (its floor); 0.51 (4x1) and 0.55 (1x4), the
router's momentum against twice the noise probe."""
import _torch_spmd
import _torch_spmd_kinds as kinds
from _torch_spmd_kinds import (  # noqa: F401 (the fixture and the checks)
    runs, test_cases_take_the_modes_they_name,
    test_constraint_placements_match_reference_spec,
    test_local_shards_match_reference_devices_indices_map,
    test_sharded_step_matches_reference, test_two_runs_are_bit_identical,
    test_world_of_one_equals_the_eager_step)

ARCHS = ("llama4-scout-17b-a16e",)
CASES = _torch_spmd.cases(ARCHS, {})


def pytest_generate_tests(metafunc):
    kinds.parametrize(metafunc, CASES, ARCHS)
