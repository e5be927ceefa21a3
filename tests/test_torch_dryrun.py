"""The port's multichip dry run (rovr_torch/parallel/dryrun.py, the JAX
package's `__graft_entry__.dryrun_multichip`) on the CPU: four gloo
processes run all eight passes at the JAX dry run's configuration (data
parallel; tensor parallel; ring; pipeline; experts; ring + experts; tensor
parallel + ring + experts; pipeline + experts), each checking step 1 and
its shard of the reconstruction; an odd count runs pass 1 only."""

from rovr_torch.parallel import dryrun


def test_dryrun_on_four_cpu_processes_runs_all_eight_passes():
    records = dryrun.dryrun_multichip(4, device="cpu")
    assert [r["index"] for r in records] == list(range(1, 9))
    assert records[0]["mesh"] == [4, 1] and records[0]["policy"] == "canvas"
    assert all(r["mesh"] == [2, 2] and r["policy"] == "attention" for r in records[1:])
    assert [(r["tp"], r["impl"], r["pp"], r["moe"]) for r in records[1:]] == [
        (True, "auto", 0, 0), (False, "ring", 0, 0), (False, "auto", 2, 0),
        (False, "auto", 0, 2), (False, "ring", 0, 2), (True, "ring", 0, 2),
        (False, "auto", 2, 2)]
    assert all(r["seconds"] > 0 for r in records)


def test_dryrun_on_an_odd_count_runs_the_data_parallel_pass():
    records = dryrun.dryrun_multichip(1, device="cpu")
    assert [(r["index"], r["mesh"]) for r in records] == [(1, [1, 1])]
