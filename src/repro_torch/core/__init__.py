"""FedAdp round engines, weighting, tree math, driver and server."""
