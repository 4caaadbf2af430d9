"""R(2+1)D-18 for Kinetics-400: network, weights, sampler, stages."""
