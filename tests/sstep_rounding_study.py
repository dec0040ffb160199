"""Is s-step CG's convergence on the ill-conditioned 1-D Laplacian of
``tests/test_sstep.py::test_sstep_ill_conditioned_matches_hs`` robust to
rounding? Not a test: a study, run by hand.

    PYTHONPATH=src python tests/sstep_rounding_study.py torch
    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_ENABLE_X64=1 \\
        PYTHONPATH=src python tests/sstep_rounding_study.py jax

For 1, 2 and 4 shards it perturbs the right-hand side ``b = 1`` by 0,
1e-14 and 1e-12 (relative, seeded) and solves with s = 2 and 4 (tol 1e-10,
maxiter 8000, a ``halo_depth = s`` partition), printing ``(iters, relres)``
per s: the JAX package (``jax``) or the port on the CPU (``torch``). A
perturbation at the rounding level flips convergence either way in both,
so which runs converge is set by rounding, not by the method.
"""

import sys

import numpy as np
import scipy.sparse as sp


def main(which: str):
    n = 256
    lap = sp.diags([-np.ones(n - 1), 2.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1])
    D = sp.diags(np.logspace(0, 1, n))
    a = (D @ lap.tocsr() @ D).tocsr()
    for S in (1, 2, 4):
        for pert in (0.0, 1e-14, 1e-12):
            b = np.ones(n) + pert * np.random.default_rng(1).standard_normal(n)
            res = []
            for s in (2, 4):
                if which == "jax":
                    from repro.core.cg import solve_cg
                    from repro.core.partition import partition_csr
                    from repro.core.spmv import shard_matrix
                    from repro.launch.mesh import make_solver_mesh

                    mesh = make_solver_mesh(S)
                    mat = shard_matrix(mesh, partition_csr(a, S, halo_depth=s))
                    r = solve_cg(mesh, mat, b, variant="sstep", s=s, tol=1e-10, maxiter=8000)
                else:
                    from repro_torch.core.cg import solve_cg
                    from repro_torch.core.partition import partition_csr

                    r = solve_cg(partition_csr(a, S, halo_depth=s), b, variant="sstep", s=s,
                                 tol=1e-10, maxiter=8000, device="cpu")
                res.append((int(r.iters), float(r.rel_residual)))
            print(which, f"shards={S} perturbation={pert:g}", res, flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "torch")
