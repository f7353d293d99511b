"""Hand-written accelerator kernels of the port and their plain versions.

``batch_lp`` holds the one kernel the system rests on (the RGB batch 2-D
LP solver, CUDA C++ under ``csrc/``) and the solver front end's two passes
around it (``prep_cuda``, ``finish_cuda``), ``ref`` its oracle on the unpacked
representation, ``ops`` the packing helper, ``crowd_grid`` the crowd's
neighbour query (its own CUDA C++ library, built at the crowd's first call
on a card), ``_build`` the first-use ``nvcc`` build.  Nothing is compiled
at import.
"""
