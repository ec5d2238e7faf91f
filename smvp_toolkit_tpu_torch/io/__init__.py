"""MatrixMarket (.mtx) reading and writing (``io.mtx``)."""
