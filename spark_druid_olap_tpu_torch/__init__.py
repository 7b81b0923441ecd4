"""PyTorch/CUDA port of the OLAP engine: SQL over star schemas, rewritten into
Druid-native GroupBy, Timeseries and TopN queries over dictionary-encoded
segments, with the group-by partial aggregation in a hand-written CUDA kernel
for NVIDIA Hopper.

Entry points: `api.TPUOlapContext(device=...).sql(text)`, and
`exec.engine.Engine(device=...).execute(query, datasource)` for native specs.
"""
