"""Sparse formats on torch tensors: COO (``formats.coo``) and CSR (``formats.csr``)."""
