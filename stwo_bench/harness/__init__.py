"""The benchmark's generic machinery: the registry of cells, the run of one
cell, the trace reduction, the work counts and the import guard."""
