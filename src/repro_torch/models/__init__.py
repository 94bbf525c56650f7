"""Language-model assembly over the paged state cache."""
