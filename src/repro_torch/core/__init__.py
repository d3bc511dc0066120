"""The business layer of the port: traffic, SLOs, costs, twins, the year
simulation and the what-if grids. Import the submodules directly; this
package imports nothing on its own."""
