"""Device decoding: frontier expansion, lattice frame loop, sweep, decoder."""
