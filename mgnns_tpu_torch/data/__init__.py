"""Host-side request encoding: texts to id/edge tensors, images to uint8 pixels."""
