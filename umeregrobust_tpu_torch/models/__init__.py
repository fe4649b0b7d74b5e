"""The sparse ResUNet backbone (nn.Module), weight loading and the
MinkowskiEngine checkpoint converter."""
