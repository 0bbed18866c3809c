"""The benchmark's general code: cells, inputs, timing, trace reading,
the bound arithmetic and the comparison with the plain reference."""
