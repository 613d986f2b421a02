"""The FairEnergy controller, channel model and fairness metric."""
