"""The model interface over ``nn.Module``s."""
