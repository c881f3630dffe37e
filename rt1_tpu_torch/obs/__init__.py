"""The port's serving observability: the Chrome-trace span ring
(`trace`), Prometheus text exposition (`prometheus`), the slow-request
exemplar ring (`recorder`), the SLO ledger (`slo`) and the shared
percentile math (`quantiles`). Copies of the JAX package's `rt1_tpu/obs/`
modules of the same names; stdlib only, so the router and the stub
replica import neither torch nor JAX.
"""
