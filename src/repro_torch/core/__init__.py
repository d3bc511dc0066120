"""The business layer of the port: the wind tunnel (schemas, synthetic
data, load patterns, spans, metrics, pipelines, experiments), traffic,
SLOs, costs, twins and their fits, the year simulation and the what-if
grids. Import the submodules directly; this package imports nothing on
its own."""
