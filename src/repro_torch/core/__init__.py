"""Counter PRNG, compartment plans, packed projector and RBD transform."""
