"""Networks of the port: EAST (ResNet-50 + merge decoder) and TRBA
(SEResNet31 + BiLSTM + attention decoder)."""
