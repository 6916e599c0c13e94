"""Host data path of the port: graph build, batches, loader, PDB input."""
