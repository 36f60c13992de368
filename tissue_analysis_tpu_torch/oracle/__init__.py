from tissue_analysis_tpu_torch.oracle.scipy_oracle import ScipyOracle  # noqa: F401
