"""Scale-out: scenario batches split over devices, and the horizon-sharded PIPG.

Counterpart of ``ocs2_tpu/parallel/``.  The port's solvers carry the scenario
axis as an explicit leading batch dim, so batching needs no transform;
``mesh.sharded`` splits that dim over a list of devices, and
``horizon.pipg_solve_horizon_sharded`` splits the stage axis of one PIPG
solve into shards that exchange halos every iteration.
"""
