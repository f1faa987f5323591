"""Assembly operators: matrix and vector assembly, the lattice (DIA) fast
path and its kernels, nest (block) assembly and the matrix-free K^H A K
operator."""
