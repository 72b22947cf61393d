"""Fine and coarse Dirac operators, their kernels' wrappers and stencils."""
