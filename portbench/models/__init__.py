"""One module a model kind: how the benchmark builds the program's runner
for a configuration file, drives its entries, and lays out the plain
reference beside it.  A configuration names its kind under "model"."""
