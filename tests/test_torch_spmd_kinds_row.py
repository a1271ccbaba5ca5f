"""The port's SPMD train step for the MoE-attention kinds in ROW mode
against the reference's jitted sharded step, on 4 CPU ``gloo`` ranks and 4
forced host devices; the checks (a) to (c) and (e) and their bounds are
``tests/_torch_spmd_kinds.py``'s (the world of one of this config:
``test_torch_spmd_kinds_moe.py``).

Case: reduced llama4-scout-17b-a16e with 2 experts on the (2, 2) mesh: an
expert a data row, its f split over ``model``, each col's routing taking
1 / ncols of its gradient. Worst measured, as a fraction of its tolerance
(``worst_fraction``): 1.0, a bf16 Adafactor momentum leaf one bf16 step
off (its floor)."""
import _torch_spmd_kinds as kinds
from _torch_spmd_kinds import (  # noqa: F401 (the fixture and the checks)
    runs, test_cases_take_the_modes_they_name,
    test_constraint_placements_match_reference_spec,
    test_local_shards_match_reference_devices_indices_map,
    test_sharded_step_matches_reference, test_two_runs_are_bit_identical)

ARCHS = ()
CASES = [("llama4-scout-17b-a16e@2x2/row", "llama4-scout-17b-a16e",
          {"num_experts": 2}, (2, 2))]


def pytest_generate_tests(metafunc):
    kinds.parametrize(metafunc, CASES, ARCHS)
