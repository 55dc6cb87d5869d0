"""IAM: identities, policy documents, STS temporary credentials."""
