"""The benchmark's plain reference: a 2-D LP solver (:mod:`.lp2d`) and frozen
copies of the input generators (:mod:`.generators`).  Plain PyTorch and
numpy; nothing of the program is imported here."""
