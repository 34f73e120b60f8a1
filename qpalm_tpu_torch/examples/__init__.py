"""The reference's examples (examples/*.py of the JAX package) on the port,
each run as a module:

    python -m qpalm_tpu_torch.examples.<name> [--device cuda|cpu]

demo, batch_demo, sparse_demo, nonconvex_demo, branch_and_bound_demo and
distributed_demo.  Each defaults to the card ("cuda"); "cpu" runs the
kernels' plain twins.  They write no files.
"""
