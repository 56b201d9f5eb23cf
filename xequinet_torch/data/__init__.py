"""Host-side data path of the port: datapoints, transforms, collation."""
