"""The port's sharded serving for the xLSTM and MoE-attention kinds against
the reference's jitted sharded prefill and decode, on 4 CPU ``gloo`` ranks
and 4 forced host devices; the checks (a) to (e) and their bounds are
``tests/_torch_spmd_serve_kinds.py``'s.

Cases: reduced xlstm-350m (``mlstm`` and ``slstm``: their state written
through ``sharding.write_slice`` into each rank's block of the cache,
the stabilizers m of a fresh cache at NEG_INF) and llama4-scout-17b-a16e
(``moe_local`` and ``moe_nope``; its MoE takes the expert-parallel path in
GRID mode on every mesh) on the (2, 2), (4, 1) and (1, 4) meshes. Worst
measured, as a fraction of its tolerance (``worst_fraction``): xlstm-350m
0.55 (2x2, an mLSTM conv state), 0.32 (4x1), 0.41 (1x4); llama4 0.75
(2x2, a decode step's logits), 0.66 (4x1), 0.55 (1x4)."""
import _torch_spmd_serve as harness
import _torch_spmd_serve_kinds as kinds
from _torch_spmd_serve_kinds import (  # noqa: F401 (fixture and checks)
    runs, test_cache_blocks_match_reference_devices_indices_map,
    test_greedy_tokens_match_where_the_gap_is_clear,
    test_sharded_serve_matches_reference, test_two_runs_are_bit_identical,
    test_world_of_one_equals_the_eager_serve)

ARCHS = ("xlstm-350m", "llama4-scout-17b-a16e")
CASES = harness.cases(ARCHS, {})


def pytest_generate_tests(metafunc):
    kinds.parametrize(metafunc, CASES, ARCHS)
