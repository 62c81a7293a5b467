"""Plain references: a NumPy Algorithm-1 reconstruction of a lineage and a
plain-torch forward of the dense and state-space models. They import
nothing of the program and take nothing the program made."""
