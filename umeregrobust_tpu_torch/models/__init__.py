"""The sparse ResUNet backbone (nn.Module) and weight loading."""
