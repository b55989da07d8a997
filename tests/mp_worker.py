"""Subprocess worker for the multi-host integration tests.

Runs the SAME library-level sharded training loop either single-process
(``--nproc 1``: one process owns all 8 virtual CPU devices) or as one rank
of a multi-process gang (``--nproc 2``: 2 processes x 4 devices, TCP
coordinator, gloo collectives).  Process 0 writes the final parameters and
per-step losses to an .npz; the test asserts the two topologies match.

Living next to the tests but NOT named test_*, so pytest never collects it
— it only runs as ``python mp_worker.py ...`` from test_multiprocess.py.
"""

import argparse
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--port", required=True)
    ap.add_argument("--mode", default="sharded",
                    choices=["sharded", "hybrid"])
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=64)
    a = ap.parse_args()

    # the harness env carries an 8-device XLA flag; each worker gets its
    # own slice of 8 total virtual devices.  Replace
    # ONLY the device-count flag (conftest's pattern) — clobbering
    # XLA_FLAGS wholesale would drop any other flags the session carries
    # and run the gang under different XLA config than the in-process
    # suite
    os.environ["JAX_PLATFORMS"] = "cpu"
    kept = [f for f in os.environ.get("XLA_FLAGS", "").split()
            if "xla_force_host_platform_device_count" not in f]
    os.environ["XLA_FLAGS"] = " ".join(
        kept + [f"--xla_force_host_platform_device_count={8 // a.nproc}"])
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    if a.nproc > 1:
        from dlrm_tpu.parallel.mesh import init_distributed

        init_distributed(f"127.0.0.1:{a.port}", a.nproc, a.pid)

    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    import dlrm_tpu
    from dlrm_tpu.data import synthetic
    from dlrm_tpu.parallel import embedding as pemb
    from dlrm_tpu.parallel.mesh import (batch_sharding, local_batch_rows,
                                        make_mesh, make_mesh_2d,
                                        param_shardings)
    from dlrm_tpu.parallel.placement import plan_placement
    from dlrm_tpu.train.train import make_sharded_train_step

    assert len(jax.devices()) == 8, jax.devices()
    config = dlrm_tpu.tiny_config(num_tables=6, rows=48, feature_size=8)
    if a.mode == "hybrid":
        # (dcn=2, ici=4): the DCN axis IS the process boundary — exactly
        # the multi-slice topology the hybrid mesh exists for
        mesh = make_mesh_2d(2, 4)
        n_shards = 4
    else:
        mesh = make_mesh(8)
        n_shards = 8
    # max_rows_per_shard forces a row-sharded table into the placement so
    # the psum_scatter/all_gather path crosses the process boundary too
    placement = plan_placement(config.table_sizes, n_shards,
                               pack=config.pack, max_rows_per_shard=24)
    params = dlrm_tpu.init_params(jax.random.key(config.seed), config)
    sh_params = {"bottom": params["bottom"],
                 "emb": pemb.shard_tables(params["emb"], placement, config),
                 "top": params["top"]}
    shardings = param_shardings(mesh, sh_params)
    sh_params = jax.device_put(sh_params, shardings)
    step = make_sharded_train_step(config, 0.1, mesh, placement)
    bs = batch_sharding(mesh)
    rows = local_batch_rows(bs, a.batch) if a.nproc > 1 else None

    losses = []
    for batch in synthetic.batch_stream(config, a.batch, a.steps, seed=7,
                                        rows=rows):
        if a.nproc > 1:
            gb = {k: jax.make_array_from_process_local_data(
                      bs, v, global_shape=(a.batch,) + v.shape[1:])
                  for k, v in batch.items()}
        else:
            gb = jax.device_put(batch, bs)
        sh_params, loss = step(sh_params, gb["dense"], gb["sparse"],
                               gb["labels"])
        losses.append(float(loss))

    # all-gather the final state host-side (replicated out_shardings runs
    # the gather ON the mesh — cross-process legal, unlike np.asarray of a
    # sharded array)
    rep = jax.tree.map(lambda _: NamedSharding(mesh, P()), sh_params)
    gathered = jax.jit(lambda t: t, out_shardings=rep)(sh_params)
    host = jax.tree.map(np.asarray, gathered)
    if a.pid == 0:
        flat = jax.tree_util.tree_flatten_with_path(host)[0]
        np.savez(a.out, losses=np.asarray(losses, np.float64),
                 **{jax.tree_util.keystr(k): v for k, v in flat})
    return 0


if __name__ == "__main__":
    sys.exit(main())
