"""Worker process for the two-process ``jax.distributed`` test.

Launched by tests/test_multihost.py as ``python multihost_worker.py
<process_id> <port>``: two OS processes × 4 virtual CPU devices each form
one global 8-device mesh (≙ the reference's ``MCMCDistributed`` across
Julia worker processes, test/runtests.jl:96-110 — here the process
boundary is real, not simulated inside one interpreter).

Checks, on each process:

1. sharded RWMH (``MCMCDistributed`` over the global mesh) is **bitwise
   equal** to the unsharded vmap run — the determinism contract
   (partitionable threefry + absolute-iteration key indexing) holds across
   process boundaries;
2. pooled RAM's shared S replicates across every chain of every process
   (the cross-chain psum rides the global mesh axis, spanning DCN in a
   real pod).

NOT a pytest file (no ``test_`` prefix): run only as a subprocess.
"""
import os
import sys


def main() -> None:
    proc_id = int(sys.argv[1])
    port = sys.argv[2]
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
    )
    import jax

    # This multi-process world runs on the CPU; select it BEFORE any
    # backend initialization.
    jax.config.update("jax_platforms", "cpu")

    from advancedmh_tpu.parallel import multihost

    multihost.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=2,
        process_id=proc_id,
    )
    assert jax.process_count() == 2, jax.process_count()
    assert jax.device_count() == 8, jax.device_count()
    assert len(jax.local_devices()) == 4, len(jax.local_devices())
    assert multihost.is_coordinator() == (proc_id == 0)
    assert multihost.process_local_chains(64) == 32

    import jax.numpy as jnp
    import numpy as np

    from advancedmh_tpu import (
        MCMCDistributed,
        MvNormal,
        RobustAdaptiveMetropolis,
        RWMH,
        sample,
    )
    from advancedmh_tpu.models.density import DensityModel

    model = DensityModel(lambda x: -0.5 * jnp.sum(x * x), dimension=2)
    mesh = multihost.global_chain_mesh()
    assert mesh.devices.size == 8

    # --- (1) sharded RWMH ≡ vmap RWMH, bitwise, across processes ---------
    spl = RWMH(MvNormal(jnp.zeros(2), scale=0.5))
    kw = dict(
        key=0, num_chains=64, initial_params=jnp.zeros(2), chain_type="raw"
    )
    sharded = sample(
        model, spl, 40, chain_method=MCMCDistributed(mesh=mesh), **kw
    )
    plain = sample(model, spl, 40, chain_method="vmap", **kw)
    ref = np.asarray(plain.transitions.params)  # replicated → addressable
    checked = 0
    for shard in sharded.transitions.params.addressable_shards:
        np.testing.assert_array_equal(np.asarray(shard.data), ref[shard.index])
        checked += shard.data.shape[0]
    assert checked == 32, checked  # this process hosts half the chains

    # --- (2) pooled RAM: ONE shared S across all chains and processes ----
    ram = RobustAdaptiveMetropolis(pooled=True)
    res = sample(
        model, ram, 10, key=1, num_chains=64, num_warmup=40,
        discard_initial=40, initial_params=jnp.zeros(2), chain_type="raw",
        chain_method=MCMCDistributed(mesh=mesh),
    )
    local_S = np.concatenate(
        [np.asarray(s.data) for s in res.final_state.S.addressable_shards],
        axis=0,
    )
    assert local_S.shape == (32, 2, 2), local_S.shape
    np.testing.assert_array_equal(
        local_S, np.broadcast_to(local_S[:1], local_S.shape)
    )
    assert not np.allclose(local_S[0], np.eye(2))  # S actually adapted
    from jax.experimental import multihost_utils

    gathered = np.asarray(multihost_utils.process_allgather(local_S[0]))
    np.testing.assert_array_equal(gathered[0], gathered[1])

    print(f"MULTIHOST_OK {proc_id}", flush=True)


if __name__ == "__main__":
    main()
