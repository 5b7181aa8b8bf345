"""Training over a (data, model) DTensor mesh: mesh.py places parameters
and batches, train.py holds the losses' AdamW steps."""
