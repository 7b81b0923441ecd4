"""PyTorch/CUDA port of the OLAP engine: Druid-native GroupBy, Timeseries and
TopN queries over dictionary-encoded segments, with the group-by partial
aggregation in a hand-written CUDA kernel for NVIDIA Hopper.

Entry point: `exec.engine.Engine(device=...).execute(query, datasource)`.
"""
